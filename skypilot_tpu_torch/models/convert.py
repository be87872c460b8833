"""Bridge a parameter tree given as numpy arrays into the port, bit-exact.

The reference's params (``skypilot_tpu.models.llama.init_params``, or a
restored checkpoint) have the same tree and layout as the port's, so the
bridge is a copy per leaf. bf16 arrays arrive as ``ml_dtypes.bfloat16``
numpy arrays, which ``torch.from_numpy`` refuses; they are recognised by
dtype name and reinterpreted through ``uint16`` — the same 16 bits —
without importing ``ml_dtypes``. :func:`train_state_from_numpy` carries
a reference train state (params and optax Adam moments) across the same
way, so both trainers can start from one mid-run state, and
:func:`resnet_params_from_numpy` a ResNet param tree (HWIO convolutions
permuted to the port's OIHW). An int8 leaf
of the reference's ``decode.quantize_params`` (its ``QuantizedTensor``
with numpy ``values`` and ``scale``) is recognised by those two fields
and becomes the port's ``ops/quant.QuantizedTensor``, bit for bit.
"""
from typing import Any, Mapping, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models import resnet
from skypilot_tpu_torch.ops import quant


def tensor_from_numpy(a, device='cpu') -> torch.Tensor:
    """One numpy array (bf16 via its bit pattern) → a torch tensor."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()    # torch.from_numpy shares memory it may write
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _is_quantized(node) -> bool:
    """A quantized leaf of either package: int8 ``values`` + ``scale``."""
    return (not isinstance(node, Mapping) and hasattr(node, 'values') and
            hasattr(node, 'scale'))


def params_from_numpy(tree: Mapping[str, Any], cfg: llama.LlamaConfig,
                      device='cpu') -> llama.Params:
    """Nested dict of numpy arrays → the port's params on ``device``
    (a llama tree, or the MoE tree of ``models/moe.py`` for a
    ``moe.MoeConfig``).

    Every leaf must have the shape the config implies (a quantized
    ``[L, in, out]`` weight: values of that shape, scales ``[L, 1,
    out]``); a mismatch is a wrong-config bridge and raises instead of
    serving garbage."""
    def leaf(node, shape, path):
        t = tensor_from_numpy(np.asarray(node), device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{path}: shape {tuple(t.shape)} != '
                             f'{tuple(shape)} for this config')
        return t

    def convert(node, shape, path):
        if isinstance(shape, dict):
            if set(node) != set(shape):
                raise ValueError(f'{path or "params"}: keys {sorted(node)} '
                                 f'!= {sorted(shape)}')
            return {k: convert(node[k], shape[k], f'{path}/{k}')
                    for k in shape}
        if _is_quantized(node):
            values = leaf(node.values, shape, f'{path}.values')
            scale = leaf(node.scale, shape[:-2] + (1, shape[-1]),
                         f'{path}.scale')
            if values.dtype != torch.int8 or scale.dtype != torch.float32:
                raise ValueError(f'{path}: quantized as {values.dtype} / '
                                 f'{scale.dtype}, not int8 / float32')
            return quant.QuantizedTensor(
                values=quant.k_major(values, values.ndim - 2), scale=scale)
        return leaf(node, shape, path)

    shapes = (moe.param_shapes(cfg) if isinstance(cfg, moe.MoeConfig)
              else llama.param_shapes(cfg))
    return convert(tree, shapes, '')


def train_state_from_numpy(params: Mapping[str, Any], adam_state: Any,
                           cfg: llama.LlamaConfig,
                           step: Optional[int] = None, device='cpu'):
    """A reference train state → the port's ``train.TrainState``.

    ``params`` is the param tree and ``adam_state`` optax's
    ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) with numpy leaves.
    Moments keep their dtype (bf16 bit for bit). ``step`` defaults to
    the Adam count, as both advance once per train step."""
    from skypilot_tpu_torch.models import train

    count = int(np.asarray(adam_state.count))
    return train.TrainState(
        params=params_from_numpy(params, cfg, device),
        opt_state=train.AdamState(
            count=count,
            mu=params_from_numpy(adam_state.mu, cfg, device),
            nu=params_from_numpy(adam_state.nu, cfg, device)),
        step=count if step is None else step)


def resnet_params_from_numpy(tree: Mapping[str, Any],
                             cfg: resnet.ResNetConfig,
                             device='cpu') -> resnet.Params:
    """The reference's ResNet params (numpy leaves; ``stages`` a list of
    lists) → the port's on ``device``: convolution weights HWIO → OIHW
    in channels-last memory, every other leaf as it is, each leaf's
    shape checked against the config."""
    def convert(node, shape, path):
        if isinstance(shape, dict):
            if set(node) != set(shape):
                raise ValueError(f'{path or "params"}: keys {sorted(node)} '
                                 f'!= {sorted(shape)}')
            return {k: convert(node[k], shape[k], f'{path}/{k}')
                    for k in shape}
        if isinstance(shape, list):
            if len(node) != len(shape):
                raise ValueError(f'{path}: {len(node)} entries != '
                                 f'{len(shape)} for this config')
            return [convert(n, s, f'{path}/{i}')
                    for i, (n, s) in enumerate(zip(node, shape))]
        t = tensor_from_numpy(np.asarray(node), device)
        if t.dim() == 4:
            t = resnet.channels_last(t.permute(3, 2, 0, 1))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{path}: shape {tuple(t.shape)} != '
                             f'{tuple(shape)} for this config')
        return t

    return convert(tree, resnet.param_shapes(cfg), '')
