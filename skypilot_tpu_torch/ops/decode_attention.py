"""Flash-decode attention over the KV cache: CUDA kernels + plain twins.

Counterpart of ``skypilot_tpu/ops/decode_attention.py``. Three kernels
carry the serving path, all in ``csrc/decode_attention.cu`` (one
templated body; see its header for the design and what bounds it):

* :func:`decode_attention_kernel` replaces the Pallas ``_decode_kernel``
  (dense cache ``[B, max_len, Hkv, hd]``);
* :func:`paged_decode_attention_kernel` replaces ``_paged_decode_kernel``
  (block pool ``[n_blocks, block_k, Hkv, hd]`` read through
  ``block_tables [B, max_blocks]``);
* :func:`paged_verify_attention_kernel` replaces ``_paged_verify_kernel``
  (speculative-decoding verify: S queries per sequence over the pool,
  query ``i`` attending positions ``<= start + i``).

Each has a plain PyTorch twin (:func:`decode_attention_plain`,
:func:`paged_decode_attention_plain`, :func:`paged_verify_attention_plain`)
mirroring the reference's ``decode_attention_xla`` numerics, bf16 casts
included; a one-query verify twin is exactly the paged decode twin. The
dispatchers :func:`decode_attention` / :func:`paged_decode_attention` /
:func:`paged_verify_attention` take the plain twin only for CPU tensors
or when the caller asks for ``'plain'``; for a CUDA tensor they launch
the kernel or raise — there is no fallback.

Every kernel wrapper counts its launches in a plain integer attribute
(``decode_attention_kernel.launches``), so a run can show that the
serving path went through the kernel.
"""
import ctypes
import functools
from typing import Optional

import torch

from skypilot_tpu_torch.ops import cuda_build

NEG_INF = -1e30
# Block size of the paged pool (and the prefill bucket granularity).
DEFAULT_BLOCK_K = 128
IMPLS = ('kernel', 'plain')

# Limit of the CUDA kernels (csrc/decode_attention.cu).
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# ------------------------------------------------------------------ plain


def grouped_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor,
                             k_scale: Optional[torch.Tensor],
                             v_scale: Optional[torch.Tensor]
                             ) -> torch.Tensor:
    """q [B,S,H,hd] vs a per-sequence cache [B,T,Hkv,hd] (int8 with fp32
    scales [B,T,Hkv] when scales are given) under ``mask`` [B,S,T]
    (True = attend) → [B,S,H,hd] in q.dtype. The one copy of the twins'
    numerics: grouped einsum in fp32, softmax, probabilities rounded to
    q's dtype, re-masked."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    qg = q.reshape(b, s, hkv, g, hd)
    logits = torch.einsum('bskgd,btkd->bkgst', qg.float(),
                          k.float()) * hd**-0.5
    mask = mask[:, None, None, :, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # A fully dead row (cur_len == 0) softmaxes to uniform over garbage;
    # re-masking zeroes it, matching the kernel's zero output.
    probs = torch.where(mask, probs, 0.0)
    out = torch.einsum('bkgst,btkd->bskgd', probs.float(), v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_len: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Grouped-einsum twin of the dense kernel: q [B,S,H,hd] vs cache
    [B,T,Hkv,hd] (int8 with fp32 scales [B,T,Hkv] when scales are
    given), positions >= cur_len [B] masked → [B,S,H,hd] in q.dtype."""
    mask = (torch.arange(k_cache.shape[1], device=q.device)[None, :] <
            cur_len.to(q.device)[:, None])                  # [B, T]
    return grouped_attention_plain(q, k_cache, v_cache, mask[:, None, :],
                                    k_scale, v_scale)


def gather_paged_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None):
    """Each sequence's cache view from the pool: [n_blocks, block_k, ...]
    + tables [B, max_blocks] → (k, v [B, max_blocks*block_k, Hkv, hd],
    scales or None). The plain path's gather; the kernel never does
    this."""
    b, n_bt = block_tables.shape
    block_k = k_pool.shape[1]
    idx = block_tables.long()

    def flat(pool):
        return pool[idx].reshape((b, n_bt * block_k) + pool.shape[2:])

    ks = flat(k_scale) if k_scale is not None else None
    vs = flat(v_scale) if v_scale is not None else None
    return flat(k_pool), flat(v_pool), ks, vs


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cur_len: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain twin of the paged kernel: table gather, then the dense
    plain path."""
    k, v, ks, vs = gather_paged_kv(k_pool, v_pool, block_tables, k_scale,
                                   v_scale)
    return decode_attention_plain(q, k, v, cur_len, ks, vs)


def paged_verify_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 start_pos: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain twin of the verify kernel: q [B,S,H,hd], query ``i`` of row
    ``b`` at position ``start_pos[b] + i`` attending positions ``<=
    start_pos[b] + i`` through the tables → [B,S,H,hd]. With S = 1 it is
    :func:`paged_decode_attention_plain` at ``cur_len = start_pos + 1``,
    bit for bit (the reference's ``paged_verify_attention_xla``)."""
    k, v, ks, vs = gather_paged_kv(k_pool, v_pool, block_tables, k_scale,
                                   v_scale)
    s = q.shape[1]
    t_idx = torch.arange(k.shape[1], device=q.device)
    last = (start_pos.to(q.device)[:, None] +
            torch.arange(s, device=q.device)[None, :])      # [B, S]
    mask = t_idx[None, None, :] <= last[:, :, None]           # [B, S, T]
    return grouped_attention_plain(q, k, v, mask, ks, vs)


# ----------------------------------------------------------------- kernel


def _check(q, k, v, k_scale, v_scale, one_query: bool = True):
    """Device/dtype/shape/contiguity checks shared by the wrappers (a
    decode call takes one query per sequence, a verify call any)."""
    tensors = [q, k, v] + [t for t in (k_scale, v_scale) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError('decode attention kernel: every tensor must be '
                         'on the same CUDA device')
    if q.dim() != 4 or q.shape[1] < 1 or (one_query and q.shape[1] != 1):
        raise ValueError(f'q must be [B, {1 if one_query else "S"}, H, hd]'
                         f', got {tuple(q.shape)}')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'q dtype {q.dtype} not supported')
    if k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise ValueError(f'cache dtypes {k.dtype}/{v.dtype} not supported')
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f'k/v must match and be 4-D, got '
                         f'{tuple(k.shape)} / {tuple(v.shape)}')
    _, _, h, hd = q.shape
    hkv = k.shape[2]
    if k.shape[3] != hd or h % hkv:
        raise ValueError(f'q {tuple(q.shape)} does not fit cache '
                         f'{tuple(k.shape)}')
    if hd > MAX_HEAD_DIM:
        raise ValueError(f'kernel takes hd <= {MAX_HEAD_DIM}; got hd={hd}')
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError('an int8 cache needs k_scale and v_scale; a '
                         'float cache takes none')
    if quantized:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != k.shape[:-1]:
                raise ValueError(f'scales must be fp32 {tuple(k.shape[:-1])}'
                                 f', got {s.dtype} {tuple(s.shape)}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('decode attention kernel takes contiguous tensors')


@functools.lru_cache(maxsize=None)
def _entry():
    """The C launcher (built and loaded at first use), typed for ctypes:
    pointers and the stream as c_void_p, sizes as c_int."""
    fn = cuda_build.load('decode_attention').skytorch_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 +
                   [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q, k, v, k_scale, v_scale, lens, tables, block_k,
            max_blocks, n_pool_blocks, verify=False):
    fn = _entry()
    b, s_q, h, hd = q.shape
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale),
                 ptr(lens), ptr(tables), ptr(out),
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], b, s_q, h,
                 k.shape[2], hd, block_k, max_blocks, n_pool_blocks,
                 int(verify), hd**-0.5, stream)
    if err != 0:
        raise RuntimeError(f'decode attention kernel launch failed '
                           f'(code {err})')
    return out


def _lengths(cur_len: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if cur_len.shape != (q.shape[0],):
        raise ValueError(f'cur_len must be [B]={q.shape[0]}, got '
                         f'{tuple(cur_len.shape)}')
    return cur_len.to(device=q.device, dtype=torch.int32).contiguous()


def _tables(block_tables: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if (block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]
            or not block_tables.is_cuda):
        raise ValueError(f'block_tables must be a CUDA [B, max_blocks] '
                         f'tensor, got {tuple(block_tables.shape)}')
    return block_tables.to(device=q.device, dtype=torch.int32).contiguous()


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cur_len: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """CUDA flash-decode over a dense cache: q [B,1,H,hd] vs
    [B,max_len,Hkv,hd] → [B,1,H,hd]. Replaces the Pallas
    ``_decode_kernel`` (skypilot_tpu/ops/decode_attention.py)."""
    _check(q, k_cache, v_cache, k_scale, v_scale)
    b, max_len = k_cache.shape[:2]
    if b != q.shape[0]:
        raise ValueError(f'cache batch {b} != q batch {q.shape[0]}')
    lens = _lengths(cur_len, q)
    out = _launch(q, k_cache, v_cache, k_scale, v_scale, lens, None,
                  block_k=max_len, max_blocks=1, n_pool_blocks=b)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


def paged_decode_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  cur_len: torch.Tensor,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """CUDA flash-decode over a block pool: position ``p`` of row ``b``
    lives in pool block ``block_tables[b, p // block_k]`` at offset
    ``p % block_k``; table entries past cur_len are never read.
    Replaces the Pallas ``_paged_decode_kernel``."""
    _check(q, k_pool, v_pool, k_scale, v_scale)
    tables = _tables(block_tables, q)
    lens = _lengths(cur_len, q)
    n_pool_blocks, block_k = k_pool.shape[:2]
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, lens, tables,
                  block_k=block_k, max_blocks=tables.shape[1],
                  n_pool_blocks=n_pool_blocks)
    paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0


def paged_verify_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  start_pos: torch.Tensor,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """CUDA multi-query verify over a block pool: q [B,S,H,hd], query
    ``i`` of row ``b`` sits at position ``start_pos[b] + i`` and attends
    positions ``<= start_pos[b] + i`` (never past the table's width) →
    [B,S,H,hd]. With S = 1 it is bit-identical to
    :func:`paged_decode_attention_kernel` at ``cur_len = start_pos + 1``.
    Replaces the Pallas ``_paged_verify_kernel``."""
    _check(q, k_pool, v_pool, k_scale, v_scale, one_query=False)
    tables = _tables(block_tables, q)
    start = _lengths(start_pos, q)
    n_pool_blocks, block_k = k_pool.shape[:2]
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, start, tables,
                  block_k=block_k, max_blocks=tables.shape[1],
                  n_pool_blocks=n_pool_blocks, verify=True)
    paged_verify_attention_kernel.launches += 1
    return out


paged_verify_attention_kernel.launches = 0

KERNELS = (decode_attention_kernel, paged_decode_attention_kernel,
           paged_verify_attention_kernel)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# --------------------------------------------------------------- dispatch


def resolved_path(device, impl: str = 'kernel') -> str:
    """Which implementation the dispatchers run for tensors on
    ``device``: 'kernel' or 'plain'. The single source of truth for the
    dispatch below, so reported numbers name the path that ran."""
    if impl not in IMPLS:
        raise ValueError(f'decode_attention must be one of {IMPLS}, got '
                         f'{impl!r}')
    device = torch.device(device)
    if impl == 'plain' or device.type == 'cpu':
        return 'plain'
    if device.type != 'cuda':
        raise ValueError(f'no decode attention kernel for {device}')
    return 'kernel'


def decode_attention(q, k_cache, v_cache, cur_len, k_scale=None,
                     v_scale=None, impl: str = 'kernel') -> torch.Tensor:
    if resolved_path(q.device, impl) == 'plain':
        return decode_attention_plain(q, k_cache, v_cache, cur_len,
                                      k_scale, v_scale)
    return decode_attention_kernel(q, k_cache, v_cache, cur_len, k_scale,
                                   v_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, cur_len,
                           k_scale=None, v_scale=None,
                           impl: str = 'kernel') -> torch.Tensor:
    if resolved_path(q.device, impl) == 'plain':
        return paged_decode_attention_plain(q, k_pool, v_pool,
                                            block_tables, cur_len,
                                            k_scale, v_scale)
    return paged_decode_attention_kernel(q, k_pool, v_pool, block_tables,
                                         cur_len, k_scale, v_scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, start_pos,
                           k_scale=None, v_scale=None,
                           impl: str = 'kernel') -> torch.Tensor:
    if resolved_path(q.device, impl) == 'plain':
        return paged_verify_attention_plain(q, k_pool, v_pool,
                                            block_tables, start_pos,
                                            k_scale, v_scale)
    return paged_verify_attention_kernel(q, k_pool, v_pool, block_tables,
                                         start_pos, k_scale, v_scale)
