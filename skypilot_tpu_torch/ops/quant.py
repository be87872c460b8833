"""Symmetric int8 quantization: the KV cache and the serving weights.

Counterpart of ``skypilot_tpu/ops/quant.py``. For the same fp32 input
the int8 values and the fp32 scales are bit-identical to the reference:
amax → ``max(amax, 1e-8) / 127`` → fp32 divide → round half to even
(``torch.round``, like ``jnp.round``) → clip to ±127 (K/V and
activation rows: the scale as the reference's jitted steps compute it,
see :func:`_symmetric_quantize`).

Int8 weights (the reference's weight + dynamic activation scheme):
weights are quantised once per output channel (:func:`quantize_int8`),
activations per row at each call (:func:`_quantize_rows`), and
``y = (x_int8 @ w_int8) * scale_x * scale_w`` with the product in exact
int32 (:func:`int8_matmul`). The reference's product is XLA's
``dot_general``, not a Pallas kernel, so on the card the int32 product
is cuBLASLt's int8 GEMM through ``torch._int_mm``
(:func:`int8_gemm_library`, with a launch counter). That GEMM takes
more than 16 rows and wants both operands K-major (``chip_smoke.py``
phase 12 times a row-major weight beside it), so :func:`quantize_int8` stores
``values`` with the contraction axis innermost (the logical shape
stays ``[..., K, N]``) and the wrapper pads short row counts with zero
rows, which change no other row. :func:`int8_matmul_plain` is the twin:
the same rows and epilogue over an exact int64 (CPU) or fp64 (CUDA:
|acc| <= 127^2 x K < 2^53) product, bit-equal to the library route.
"""
import dataclasses
from typing import Optional, Tuple

import torch

_INT8_MAX = 127.0
# torch._int_mm on CUDA refuses 16 rows or fewer.
LIBRARY_MIN_ROWS = 17


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 ``values`` (logical ``[..., K, N]``, stored K-major) + fp32
    ``scale`` broadcastable against the matmul output."""
    values: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def nbytes(self) -> int:
        return self.values.nbytes + self.scale.nbytes

    def __getitem__(self, i) -> 'QuantizedTensor':
        """Both fields sliced alike: a stacked ``[L, K, N]`` weight's
        layer ``i`` (``llama.layer_params``)."""
        return QuantizedTensor(values=self.values[i], scale=self.scale[i])


def _symmetric_quantize(x: torch.Tensor, axis: int,
                        reciprocal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """amax → floored scale → round/clip; returns (int8, fp32 scale).
    ``reciprocal``: the scale is ``floored * (1/127)``, what XLA folds
    the reference's ``floored / 127`` into under ``jit`` (one ulp apart
    in ~5% of scales)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    floored = torch.clamp(amax, min=1e-8)
    scale = (floored * (1.0 / _INT8_MAX) if reciprocal else
             floored / _INT8_MAX)
    q = torch.clamp(torch.round(x32 / scale), -_INT8_MAX,
                    _INT8_MAX).to(torch.int8)
    return q, scale


def k_major(values: torch.Tensor, axis: int) -> torch.Tensor:
    """The same int8 values with ``axis`` (the contraction) innermost in
    memory, as the library GEMM wants them; the shape is unchanged."""
    return values.movedim(axis, -1).contiguous().movedim(-1, axis)


def quantize_int8(w: torch.Tensor, axis: int = 0) -> QuantizedTensor:
    """Symmetric per-channel quantization of a weight. ``axis`` is the
    CONTRACTION axis; each remaining (output) channel gets its own
    scale."""
    q, scale = _symmetric_quantize(w, axis)
    return QuantizedTensor(values=k_major(q, axis), scale=scale)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row activation quantization: [..., K] → int8 +
    scale [..., 1]. The reference quantises activations only inside its
    jitted steps, so the scale takes XLA's reciprocal form; weights
    (:func:`quantize_int8`) are quantised eagerly there and divide."""
    return _symmetric_quantize(x, -1, reciprocal=True)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Hkv, hd] → (int8 [..., Hkv, hd], fp32 scales [..., Hkv]):
    one scale per (position, kv head), the granularity the decode
    kernels dequantise at. The reference quantises K/V only inside its
    jitted prefill and decode, so the scale takes XLA's reciprocal form,
    as the activation rows do: a pool block reads the same bits on
    either package, which is what lets a replica adopt blocks another
    one wrote."""
    q, scale = _symmetric_quantize(x, -1, reciprocal=True)
    return q, scale[..., 0]


# ------------------------------------------------------- the int32 product


def _check_product(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f'int8 product needs int8 operands, got '
                         f'{xq.dtype} and {wq.dtype}')
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f'int8 product of {tuple(xq.shape)} and '
                         f'{tuple(wq.shape)}')
    if xq.device != wq.device:
        raise ValueError(f'operands on {xq.device} and {wq.device}')


def int8_gemm_library(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 → [M, N] int32 through cuBLASLt
    (``torch._int_mm``) on the card. Rows are padded with zeros to
    LIBRARY_MIN_ROWS; the weight must be K-major (:func:`k_major`)."""
    _check_product(xq, wq)
    if xq.device.type != 'cuda':
        raise ValueError(f'the int8 library GEMM runs on CUDA tensors, '
                         f'got {xq.device}')
    if wq.stride(0) != 1:
        raise ValueError('the int8 library GEMM needs a K-major weight '
                         '(quant.k_major)')
    m = xq.shape[0]
    if m < LIBRARY_MIN_ROWS:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, LIBRARY_MIN_ROWS - m))
    acc = torch._int_mm(xq.contiguous(), wq)  # pylint: disable=protected-access
    int8_gemm_library.launches += 1
    return acc[:m]


int8_gemm_library.launches = 0


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The same int32 product, exact by construction: int64 on the CPU,
    fp64 on the card (every partial sum is an integer below 2^53)."""
    _check_product(xq, wq)
    if xq.device.type == 'cpu':
        return (xq.long() @ wq.long()).to(torch.int32)
    return (xq.double() @ wq.double()).to(torch.int32)


def _product(device):
    """The int32 product for tensors on ``device``: the twin on the CPU,
    the library GEMM on CUDA (never the twin), nothing elsewhere."""
    device = torch.device(device)
    if device.type == 'cpu':
        return int8_gemm_plain
    if device.type != 'cuda':
        raise ValueError(f'no int8 GEMM for {device}')
    return int8_gemm_library


def _int8_matmuls(x: torch.Tensor, qws, out_dtype, product) -> list:
    """x @ each of ``qws``, x's rows quantised once: the same rows and
    scales as one call per weight, with fewer launches."""
    for qw in qws:
        if qw.values.ndim != 2:
            raise ValueError(f'int8_matmul takes a 2-D quantized weight '
                             f'(one layer of a stacked one); got shape '
                             f'{tuple(qw.values.shape)}')
    out_dtype = out_dtype or x.dtype
    xq, sx = _quantize_rows(x)
    rows = xq.reshape(-1, xq.shape[-1])
    out = []
    for qw in qws:
        n = qw.values.shape[1]
        acc = product(rows, qw.values).reshape(x.shape[:-1] + (n,))
        y = acc.float() * sx * qw.scale.reshape((1,) * (acc.ndim - 1) +
                                                (-1,))
        out.append(y.to(out_dtype))
    return out


def int8_matmuls(x: torch.Tensor, qws,
                 out_dtype: Optional[torch.dtype] = None) -> list:
    """``[x @ w for w in qws]`` with both operands int8: x [..., K]
    float, each qw [K, N] → [..., N] in ``out_dtype`` (default x.dtype).
    The int32 products run on the library GEMM for CUDA tensors and on
    the twin for CPU tensors."""
    return _int8_matmuls(x, qws, out_dtype, _product(x.device))


def int8_matmul(x: torch.Tensor, qw: QuantizedTensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` with both operands int8 (:func:`int8_matmuls` of one
    weight): the reference's ``int8_matmul``."""
    return int8_matmuls(x, (qw,), out_dtype)[0]


def int8_matmul_plain(x: torch.Tensor, qw: QuantizedTensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The twin of :func:`int8_matmul`: bit-equal on every device."""
    return _int8_matmuls(x, (qw,), out_dtype, int8_gemm_plain)[0]
