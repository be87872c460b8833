"""Training on one device: optimizer, train step, MFU accounting, loop.

Counterpart of ``skypilot_tpu/models/train.py`` for a single device (the
mesh, multislice and multi-process paths are not ported, and the CLI
refuses them). The optimizer is written as plain functions on tensors
that reproduce optax's arithmetic step for step, for
``chain(clip_by_global_norm(grad_clip), adamw(schedule))``:

* ``clip_by_global_norm``: rescale by ``max_norm / norm`` only when
  ``norm >= max_norm``; the ``grad_norm`` metric is the pre-clip norm;
* ``scale_by_adam`` (or the reference's ``_scale_by_adam_low_mem`` for
  a ``moment_dtype`` other than 'float32'), ``add_decayed_weights``,
  ``scale_by_learning_rate`` with the learning rate rounded to the
  update's dtype, then ``params + updates`` cast to the param dtype;
* ``warmup_cosine_decay_schedule(0, lr, warmup, max(10 * warmup, 1000))``
  read at the count *before* the step, so step 1 runs at lr 0.

Quirk kept from the reference: ``optax.adamw`` on bf16 params stores its
moments in bf16, so ``moment_dtype='float32'`` (the default) means
moments in the param dtype, not fp32.

The step updates params and moments in place (the reference donates its
state to the jitted step) and returns the same state object.
"""
import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import checkpoint as ckpt_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import runtime_metrics

Params = llama.Params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # Storage dtype for the Adam moments. 'float32' is optax.adamw, whose
    # moments take the param dtype (bf16 for bf16 params); any other
    # value stores mu and nu in that dtype with the update math in fp32.
    moment_dtype: str = 'float32'


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and both moments."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamState
    step: int


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in ``jax.tree.leaves`` order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """``warmup_cosine_decay_schedule(0, lr, warmup, max(10 * warmup,
    1000))`` at ``count``, in float32 as optax computes it."""
    f32 = np.float32
    warmup = cfg.warmup_steps
    decay_steps = max(10 * warmup, 1000)
    if count < warmup:
        frac = f32(1) - f32(max(count, 0)) / f32(warmup)
        return float(f32(0.0 - cfg.learning_rate) * frac +
                     f32(cfg.learning_rate))
    t = f32(min(count - warmup, decay_steps - warmup))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t /
                                         f32(decay_steps - warmup)))
    return float(f32(cfg.learning_rate) * cosine)


def _moment_dtype(cfg: TrainConfig, param: torch.Tensor) -> torch.dtype:
    if cfg.moment_dtype == 'float32':
        return param.dtype
    return getattr(torch, cfg.moment_dtype)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32."""
    return float(np.float32(1) - np.float32(decay)**np.float32(count))


def global_norm(tree) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the summed squares of every leaf, in
    the leaves' dtype (each leaf's sum taken in fp32)."""
    leaves = tree_leaves(tree)
    dtype = leaves[0].dtype
    total = sum(torch.sum(x.float() * x.float()).to(dtype) for x in leaves)
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) → AdamState``; ``update(grads, state, params) →
    pre-clip grad norm`` applies one step to params and moments in
    place."""
    init: Callable[[Params], AdamState]
    update: Callable[[Params, AdamState, Params], torch.Tensor]


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
    low_mem = cfg.moment_dtype != 'float32'

    def init(params: Params) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=_moment_dtype(cfg, p))
        return AdamState(count=0, mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def adam(g, mu, nu, count):
        """One leaf's scaled update; writes the new moments."""
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        if low_mem:
            mu32 = mu.float() * b1 + g.float() * (1 - b1)
            nu32 = nu.float() * b2 + torch.square(g.float()) * (1 - b2)
            mu.copy_(mu32)
            nu.copy_(nu32)
            return (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / torch.tensor(bc1).to(mu.dtype)
        nu_hat = nu / torch.tensor(bc2).to(nu.dtype)
        return mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)

    @torch.no_grad()
    def update(grads: Params, state: AdamState,
               params: Params) -> torch.Tensor:
        norm = global_norm(grads)
        clip = not bool(norm < cfg.grad_clip)
        count = state.count + 1
        lr = -learning_rate(cfg, state.count)
        for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                                tree_leaves(state.mu),
                                tree_leaves(state.nu)):
            if clip:
                g = (g / norm.to(g.dtype)) * cfg.grad_clip
            u = adam(g, mu, nu, count)
            u = u + cfg.weight_decay * p
            u = torch.tensor(lr).to(u.dtype) * u
            p.copy_(p + u)
        state.count = count
        return norm

    return Optimizer(init=init, update=update)


def init_train_state(model_cfg: llama.LlamaConfig, train_cfg: TrainConfig,
                     device=None) -> TrainState:
    """Random params (seed 0, as the reference's PRNGKey(0); the draws
    differ from ``jax.random``'s) and zero Adam state on ``device``
    (default CUDA; without a card only ``device='cpu'`` runs)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = llama.init_params(model_cfg, gen, device)
    return TrainState(params=params,
                      opt_state=make_optimizer(train_cfg).init(params),
                      step=0)


def make_train_step(model_cfg: llama.LlamaConfig, train_cfg: TrainConfig):
    """Returns ``(state, tokens, targets) → (state, metrics)`` with
    metrics ``loss`` and ``grad_norm`` (0-dim tensors)."""
    opt = make_optimizer(train_cfg)

    def step_fn(state: TrainState, tokens, targets
                ) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        device = leaves[0].device
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = llama.loss_fn(state.params, tokens, targets, model_cfg)
            flat = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _unflatten(state.params, list(flat))
        grad_norm = opt.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {'loss': loss.detach(), 'grad_norm': grad_norm}

    return step_fn


def _unflatten(like, leaves: List[torch.Tensor]):
    """Inverse of ``tree_leaves`` onto the structure of ``like``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return leaves.pop(0)


def tokens_per_second_to_mfu(tokens_per_sec: float,
                             model_cfg: llama.LlamaConfig, seq_len: int,
                             peak_flops: float) -> float:
    """Model FLOPs utilization given hardware peak (bf16) FLOPs/sec."""
    return tokens_per_sec * model_cfg.flops_per_token(seq_len) / peak_flops


def synthetic_batch(vocab_size: int, batch_size: int, seq_len: int,
                    data_seed: int, step: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's deterministic synthetic stream: uniform tokens
    from ``SeedSequence([data_seed, step])``, targets rolled by one."""
    rng = np.random.default_rng(np.random.SeedSequence([data_seed, step]))
    tokens = rng.integers(0, vocab_size, (batch_size, seq_len),
                          dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def train_loop(model_cfg: llama.LlamaConfig,
               train_cfg: TrainConfig,
               num_steps: int,
               batch_size: int,
               seq_len: int,
               checkpoint_dir: Optional[str] = None,
               save_every: int = 100,
               keep: int = 3,
               data_seed: int = 0,
               log_every: int = 10,
               sleep_per_step: float = 0.0,
               dataset: Optional[Any] = None,
               device=None,
               on_step: Optional[Callable[[int, Dict[str, Any]],
                                          None]] = None) -> TrainState:
    """Run (or RESUME) a training run with periodic checkpointing.

    If ``checkpoint_dir`` holds a complete checkpoint, params, Adam
    moments and step restore from it and the loop continues at step N.
    Batches are a pure function of ``(data_seed, step)``, so a resumed
    run sees the stream it would have seen unpreempted. Each step is
    published through ``observability/runtime_metrics.TrainTelemetry``
    (step seconds, tokens/s, MFU, steps), ``SKYTPU_PROFILE_DIR`` arms a
    ``StepProfiler`` capture, and ``on_step(step, metrics)`` is called
    after every step."""
    dev = resolve_device(device)
    start_step = 0
    state = None
    if checkpoint_dir:
        restored = ckpt_lib.restore_latest(checkpoint_dir, device=dev)
        if restored is not None:
            state, start_step = restored
            print(f'[train] resumed from step {start_step} '
                  f'({checkpoint_dir})', flush=True)
    if state is None:
        state = init_train_state(model_cfg, train_cfg, dev)
    step_fn = make_train_step(model_cfg, train_cfg)
    # No explicit step_start(): the first record_step silently arms the
    # timer, so the first step (kernel builds, allocator warm-up) never
    # enters the step-time histogram.
    telemetry = runtime_metrics.TrainTelemetry(model_cfg=model_cfg,
                                               seq_len=seq_len, device=dev)
    profiler = runtime_metrics.StepProfiler(tag='train')
    for step in range(start_step, num_steps):
        profiler.step()
        if dataset is not None:
            tokens, targets = dataset.batch(step, batch_size, seq_len,
                                            seed=data_seed)
        else:
            tokens, targets = synthetic_batch(model_cfg.vocab_size,
                                              batch_size, seq_len,
                                              data_seed, step)
        state, metrics = step_fn(state, tokens, targets)
        telemetry.record_step(tokens=batch_size * seq_len)
        if on_step is not None:
            on_step(step + 1, metrics)
        if sleep_per_step:
            time.sleep(sleep_per_step)
        if log_every and (step + 1) % log_every == 0:
            print(f'[train] step {step + 1}/{num_steps} '
                  f'loss={float(metrics["loss"]):.4f}', flush=True)
        if checkpoint_dir and (step + 1) % save_every == 0:
            ckpt_lib.save(checkpoint_dir, state, step + 1, keep=keep)
            print(f'[train] checkpoint @ step {step + 1}', flush=True)
    profiler.stop()
    if (checkpoint_dir and num_steps > start_step and
            num_steps % save_every != 0):  # loop already saved otherwise
        ckpt_lib.save(checkpoint_dir, state, num_steps, keep=keep)
        print(f'[train] final checkpoint @ step {num_steps}', flush=True)
    return state


def main(argv: Optional[List[str]] = None) -> None:
    """CLI for recipes: ``python -m skypilot_tpu_torch.models.train``."""
    parser = argparse.ArgumentParser(
        description='skypilot_tpu_torch train loop (one device)')
    parser.add_argument('--model', default='debug',
                        choices=sorted(llama.CONFIGS))
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=2)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--save-every', type=int, default=10)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--sleep-per-step', type=float, default=0.0)
    parser.add_argument('--num-slices', type=int,
                        default=int(os.environ.get('MEGASCALE_NUM_SLICES',
                                                   '1')))
    parser.add_argument('--data', default=None,
                        help='token file (models/data.py format); '
                        'default: deterministic synthetic stream')
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda; a machine '
                        'without a card needs --device cpu)')
    args = parser.parse_args(argv)
    if args.num_slices > 1:
        parser.error(f'--num-slices {args.num_slices}: multislice training '
                     'is not ported to skypilot_tpu_torch yet')
    if int(os.environ.get('JAX_NUM_PROCESSES', '1')) > 1:
        parser.error('JAX_NUM_PROCESSES > 1: multi-process training is not '
                     'ported to skypilot_tpu_torch yet')
    device = resolve_device(args.device)
    cfg = llama.CONFIGS[args.model]
    dataset = None
    if args.data:
        from skypilot_tpu_torch.models import data as data_lib
        dataset = data_lib.TokenDataset.open(args.data)
        if dataset.vocab_size > cfg.vocab_size:
            raise SystemExit(
                f'Dataset vocab {dataset.vocab_size} exceeds model '
                f'vocab {cfg.vocab_size}.')
    state = train_loop(cfg, TrainConfig(warmup_steps=5), args.steps,
                       args.batch_size, args.seq_len,
                       checkpoint_dir=args.checkpoint_dir,
                       save_every=args.save_every,
                       log_every=args.log_every,
                       sleep_per_step=args.sleep_per_step,
                       dataset=dataset, device=device)
    print(f'[train] done at step {state.step}', flush=True)


if __name__ == '__main__':
    main()
