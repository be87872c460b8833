"""ResNet in plain PyTorch: forward, loss, momentum-SGD train step, CLI.

Counterpart of ``skypilot_tpu/models/resnet.py`` on one device. The
param tree is the reference's (``stem``, ``stem_scale``/``stem_shift``,
``stages`` as a list of lists of block dicts, ``head``) with the
convolution weights in torch's OIHW order instead of the reference's
HWIO (``models/convert.resnet_params_from_numpy`` permutes them).

Numerics follow the reference step for step: images [N, H, W, 3] cast
to the model dtype; convolutions in the model dtype (cuDNN's on the
card, in channels-last layout, which a permuted NHWC batch already
has); training-mode batch norm without running stats, its statistics in
fp32 with the population variance; the residual add and ReLU in fp32
cast back; the global mean pool and the head product in fp32.

Padding is XLA's ``'SAME'``: ``ceil(n / stride)`` outputs with the odd
pad at the end, so a stride-2 layer on an even size pads (k//2 - 1,
k//2) — (2, 3) for the 7x7 stem, (0, 1) for a 3x3 conv or the 3x3 max
pool — which ``padding=k//2`` would not give.
"""
import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    # Stage widths and block counts; resnet50-style bottlenecks when
    # bottleneck=True, basic blocks (resnet18/34) otherwise.
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    width: int = 64
    bottleneck: bool = False
    num_classes: int = 1000
    dtype: Any = torch.bfloat16

    @property
    def stage_widths(self) -> List[int]:
        return [self.width * (2**i) for i in range(len(self.stage_sizes))]


CONFIGS: Dict[str, ResNetConfig] = {
    'resnet18': ResNetConfig(),
    'resnet50': ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    'resnet101': ResNetConfig(stage_sizes=(3, 4, 23, 3), bottleneck=True),
    'debug': ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=10),
}


def _blocks(cfg: ResNetConfig):
    """(stage, block, stride, cin, width, cout) of every block."""
    cin = cfg.width
    for stage, (blocks, width) in enumerate(
            zip(cfg.stage_sizes, cfg.stage_widths)):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            cout = width * (4 if cfg.bottleneck else 1)
            yield stage, b, stride, cin, width, cout
            cin = cout


def param_shapes(cfg: ResNetConfig) -> Params:
    """The param tree's shapes (convolutions OIHW), same structure as
    the params."""
    shapes: Params = {'stem': (cfg.width, 3, 7, 7),
                      'stem_scale': (cfg.width,),
                      'stem_shift': (cfg.width,),
                      'stages': [[] for _ in cfg.stage_sizes]}
    cout = cfg.width
    for stage, _, stride, cin, width, cout in _blocks(cfg):
        if cfg.bottleneck:
            blk = {'conv1': (width, cin, 1, 1),
                   'conv2': (width, width, 3, 3),
                   'conv3': (cout, width, 1, 1)}
            norms = (width, width, cout)
        else:
            blk = {'conv1': (width, cin, 3, 3),
                   'conv2': (cout, width, 3, 3)}
            norms = (width, cout)
        for i, n in enumerate(norms):
            blk[f'scale{i + 1}'] = blk[f'shift{i + 1}'] = (n,)
        if stride != 1 or cin != cout:
            blk['proj'] = (cout, cin, 1, 1)
        shapes['stages'][stage].append(blk)
    shapes['head'] = (cout, cfg.num_classes)
    return shapes


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device='cpu') -> Params:
    """Random params from ``generator`` (on ``device``): convolutions
    normal(0, 1) x sqrt(2 / fan_in) in the model dtype, channels-last;
    norm scales ones and shifts zeros in fp32; the head normal x
    sqrt(1 / cin). Draws differ from the reference's ``jax.random``;
    parity tests bridge the reference's own params instead."""

    def normal(shape, std):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, 1.0, generator=generator)
        return (w * std).to(cfg.dtype)

    def init(name, shape):
        if name.startswith('scale'):
            return torch.ones(shape, dtype=torch.float32, device=device)
        if name.startswith('shift'):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        fan_in = shape[1] * shape[2] * shape[3]
        return channels_last(normal(shape, (2.0 / fan_in)**0.5))

    shapes = param_shapes(cfg)
    return {
        'stem': init('stem', shapes['stem']),
        'stem_scale': init('scale', shapes['stem_scale']),
        'stem_shift': init('shift', shapes['stem_shift']),
        'stages': [[{k: init(k, s) for k, s in blk.items()}
                    for blk in stage] for stage in shapes['stages']],
        'head': normal(shapes['head'], (1.0 / shapes['head'][0])**0.5),
    }


def channels_last(w: torch.Tensor) -> torch.Tensor:
    """A 4-D tensor in channels-last memory (what cuDNN's NHWC kernels
    read); other tensors unchanged."""
    if w.dim() == 4:
        return w.contiguous(memory_format=torch.channels_last)
    return w


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (sorted dict keys, lists in
    order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, node) for node in tree]
    return fn(tree)


# ---------------------------------------------------------------- forward


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial axis: (before, after), the
    odd pad after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = (same_pads(n, k, stride)
                                    for n in x.shape[2:])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """x [N, C, H, W] (channels-last) ⊛ w OIHW, SAME, in x's dtype."""
    k = w.shape[-1]
    pads = [same_pads(n, k, stride) for n in x.shape[2:]]
    w = w.to(x.dtype)
    if all(lo == hi for lo, hi in pads):
        return F.conv2d(x, w, stride=stride,
                        padding=tuple(lo for lo, _ in pads))
    return F.conv2d(_pad_same(x, k, stride), w, stride=stride)


def _norm_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              relu: bool = True) -> torch.Tensor:
    """Training-mode batch norm without running stats: fp32 statistics
    over (N, H, W), the population variance (``jnp.var``)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3), keepdim=True)
    var = x32.var(dim=(0, 2, 3), correction=0, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + 1e-5) * scale[:, None, None] +
         shift[:, None, None])
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _block_forward(cfg: ResNetConfig, x: torch.Tensor, blk: Params,
                   stride: int) -> torch.Tensor:
    identity = x
    if cfg.bottleneck:
        y = _norm_act(_conv(x, blk['conv1']), blk['scale1'], blk['shift1'])
        y = _norm_act(_conv(y, blk['conv2'], stride), blk['scale2'],
                      blk['shift2'])
        y = _norm_act(_conv(y, blk['conv3']), blk['scale3'], blk['shift3'],
                      relu=False)
    else:
        y = _norm_act(_conv(x, blk['conv1'], stride), blk['scale1'],
                      blk['shift1'])
        y = _norm_act(_conv(y, blk['conv2']), blk['scale2'], blk['shift2'],
                      relu=False)
    if 'proj' in blk:
        identity = _conv(x, blk['proj'], stride)
    return torch.relu((y + identity).float()).to(x.dtype)


def forward(params: Params, images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images [N, H, W, 3] → logits [N, num_classes] fp32."""
    # NHWC → an NCHW view whose memory is channels-last.
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    x = _norm_act(_conv(x, params['stem'], stride=2), params['stem_scale'],
                  params['stem_shift'])
    x = F.max_pool2d(_pad_same(x, 3, 2, value=float('-inf')), 3, 2)
    for stage, stage_params in enumerate(params['stages']):
        for b, blk in enumerate(stage_params):
            stride = 2 if (b == 0 and stage > 0) else 1
            x = _block_forward(cfg, x, blk, stride)
    x = x.float().mean(dim=(2, 3))
    return x @ params['head'].float()


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """Mean softmax cross-entropy, a scalar fp32 tensor."""
    logits = forward(params, images, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()


def zeros_momentum(params: Params):
    """fp32 zeros in the params' structure (and memory format)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def make_train_step(cfg: ResNetConfig, lr: float = 0.1):
    """Returns ``(params, momentum, images, labels) → (params, momentum,
    loss)``: momentum 0.9 SGD with fp32 momentum, params updated in fp32
    then cast back, both in place (the reference donates them)."""

    def step(params, momentum, images, labels):
        leaves = tree_leaves(params)
        device = leaves[0].device
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, images, labels, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            for p, m, g in zip(leaves, tree_leaves(momentum), grads):
                m.copy_(0.9 * m + g.float())
                p.copy_(p.float() - lr * m)
        return params, momentum, loss.detach()

    return step


def main(argv: Optional[List[str]] = None) -> None:
    """Throughput bench CLI (examples/sec), one device:
    ``python -m skypilot_tpu_torch.models.resnet``."""
    parser = argparse.ArgumentParser(
        description='skypilot_tpu_torch ResNet train-step throughput')
    parser.add_argument('--model', default='resnet101',
                        choices=sorted(CONFIGS))
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--image-size', type=int, default=224)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--data-parallel', action='store_true',
                        help='not ported: one device only')
    parser.add_argument('--distributed', action='store_true',
                        help='not ported: one device only')
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda; a machine '
                        'without a card needs --device cpu)')
    args = parser.parse_args(argv)
    for flag in ('data_parallel', 'distributed'):
        if getattr(args, flag):
            parser.error(f'--{flag.replace("_", "-")}: multi-device '
                         'training is not ported to skypilot_tpu_torch yet')
    device = resolve_device(args.device)
    cfg = CONFIGS[args.model]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    momentum = zeros_momentum(params)
    step = make_train_step(cfg)
    gen.manual_seed(1)
    images = torch.randn((args.batch_size, args.image_size,
                          args.image_size, 3), generator=gen,
                         device=device)
    gen.manual_seed(2)
    labels = torch.randint(0, cfg.num_classes, (args.batch_size,),
                           generator=gen, device=device)
    params, momentum, loss = step(params, momentum, images, labels)
    float(loss)  # sync: the first step (cuDNN's autotuning) is untimed
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, momentum, loss = step(params, momentum, images, labels)
    final = float(loss)
    dt = time.perf_counter() - t0
    print(json.dumps({
        'metric': 'resnet_train_examples_per_sec',
        'model': args.model,
        'value': round(args.steps * args.batch_size / dt, 1),
        'unit': 'examples/s',
        'n_devices': 1,
        'loss': round(final, 4),
    }), flush=True)


if __name__ == '__main__':
    main()
