"""Symmetric int8 quantization for the KV cache.

Counterpart of ``skypilot_tpu/ops/quant.py`` (``_symmetric_quantize``,
``quantize_kv``). For the same fp32 input the int8 values and the fp32
scales are bit-identical to the reference: amax → ``max(amax, 1e-8) /
127`` → fp32 divide → round half to even (``torch.round``, like
``jnp.round``) → clip to ±127. Int8 weights (``int8_matmul``) belong to
a later slice.
"""
from typing import Tuple

import torch

_INT8_MAX = 127.0


def _symmetric_quantize(x: torch.Tensor,
                        axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """amax → floored scale → round/clip; returns (int8, fp32 scale)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / _INT8_MAX
    q = torch.clamp(torch.round(x32 / scale), -_INT8_MAX,
                    _INT8_MAX).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Hkv, hd] → (int8 [..., Hkv, hd], fp32 scales [..., Hkv]):
    one scale per (position, kv head), the granularity the decode
    kernels dequantise at."""
    q, scale = _symmetric_quantize(x, -1)
    return q, scale[..., 0]
