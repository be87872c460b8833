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

Each launcher call runs two kernels on the current stream: the split
kernel (each CTA one fixed span of :data:`SPLIT_SPAN` positions, writing
fp32 partials (m, l, acc) into a workspace :func:`_launch` allocates)
and the combine kernel that merges a row's live splits in order. bf16
queries over a bf16 or int8 cache at head_dim % 16 == 0 run the split
kernel on tensor cores (:func:`uses_tensor_cores`), the rest on CUDA
cores.

Each has a plain PyTorch twin (:func:`decode_attention_plain`,
:func:`paged_decode_attention_plain`, :func:`paged_verify_attention_plain`)
mirroring the reference's ``decode_attention_xla`` numerics, bf16 casts
included; a one-query verify twin is exactly the paged decode twin. The
split and the combine have their own twins (:func:`split_partials_plain`,
:func:`combine_partials_plain`) for the tests; the serving path never
calls them. The
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
# Cache positions per split of the kernels (their kSpan): a row's
# positions [j * SPLIT_SPAN, (j + 1) * SPLIT_SPAN) go to split j.
SPLIT_SPAN = 256
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


def split_partials_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, row_len: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         span: int = SPLIT_SPAN):
    """Plain twin of the kernels' split partials (tests only; the
    serving path never calls it): q [B,S,H,hd] against a per-sequence
    cache [B,T,Hkv,hd] (int8 with fp32 scales [B,T,Hkv]), row (b, i)
    attending positions ``< row_len[b, i]`` → (m, l [B,S,H,n], acc
    [B,S,H,n,hd]) in fp32, n = ceil(T / span). Split j covers positions
    [j * span, (j + 1) * span): its largest logit m, l = sum exp(logit -
    m) and acc = sum exp(logit - m) v over the row's live positions
    there; a split with none gives (NEG_INF, 0, 0)."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    logits = torch.einsum('bskgd,btkd->bskgt',
                          q.float().reshape(b, s, hkv, g, hd), kf)
    logits = logits.reshape(b, s, h, t) * hd**-0.5
    live = (torch.arange(t, device=q.device)[None, None, :] <
            row_len.to(q.device)[:, :, None])[:, :, None, :]  # [B,S,1,T]
    ms, ls, accs = [], [], []
    for j in range(-(-t // span)):
        sl = slice(j * span, min((j + 1) * span, t))
        lg, lv = logits[..., sl], live[..., sl]
        m = torch.where(lv, lg, NEG_INF).amax(-1)
        p = torch.where(lv, torch.exp(lg - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum('bskgt,btkd->bskgd',
                                 p.reshape(b, s, hkv, g, -1),
                                 vf[:, sl]).reshape(b, s, h, hd))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor, row_len: torch.Tensor,
                           dtype: torch.dtype,
                           span: int = SPLIT_SPAN) -> torch.Tensor:
    """Plain twin of the combine kernel: partials (m, l [B,S,H,n], acc
    [B,S,H,n,hd]) → [B,S,H,hd] in ``dtype``. Row (b, i) reduces only
    its splits that start below ``row_len[b, i]``, in split order: m* =
    max m_j, l* = sum l_j exp(m_j - m*), out = sum acc_j exp(m_j - m*) /
    max(l*, 1e-20). A row of length 0 comes out exactly zero."""
    n = m.shape[-1]
    n_live = (row_len.to(m.device).long() + span - 1) // span     # [B,S]
    live = (torch.arange(n, device=m.device)[None, None, :] <
            n_live[:, :, None])[:, :, None, :].expand_as(m)
    m_max = torch.where(live, m, NEG_INF).amax(-1)
    out_l = torch.zeros_like(m_max)
    out_acc = torch.zeros_like(acc[..., 0, :])
    for j in range(n):   # a dead split's values are never used
        lj = live[..., j]
        w = torch.exp(m[..., j] - m_max)
        out_l = out_l + torch.where(lj, l[..., j] * w, 0.0)
        out_acc = out_acc + torch.where(lj[..., None],
                                        acc[..., j, :] * w[..., None], 0.0)
    return (out_acc / out_l.clamp_min(1e-20)[..., None]).to(dtype)


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


def uses_tensor_cores(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                      head_dim: int) -> bool:
    """Which body the CUDA launcher runs, by dtype and shape alone (its
    ``uses_mma``): the tensor-core body (mma.sync, bf16 K/V tiles) for
    bf16 q over a bf16 or int8 cache at head_dim % 16 == 0, the
    CUDA-core body otherwise (fp32 q stays exact fp32). Never a fallback
    after a failure."""
    return (q_dtype == torch.bfloat16 and
            kv_dtype in (torch.bfloat16, torch.int8) and head_dim % 16 == 0)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, built and loaded at first use; refuses one
    whose split span is not :data:`SPLIT_SPAN`."""
    lib = cuda_build.load('decode_attention')
    if lib.skytorch_decode_attention_span() != SPLIT_SPAN:
        raise RuntimeError(f'decode attention library splits every '
                           f'{lib.skytorch_decode_attention_span()} '
                           f'positions, the wrapper {SPLIT_SPAN}')
    return lib


@functools.lru_cache(maxsize=None)
def _entry():
    """The C launcher (built and loaded at first use), typed for ctypes:
    pointers and the stream as c_void_p, sizes as c_int."""
    fn = _library().skytorch_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 +
                   [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q, k, v, k_scale, v_scale, lens, tables, block_k,
            max_blocks, n_pool_blocks, verify=False, partials=None):
    """One launcher call: the split kernel, then the combine kernel, on
    the current stream. ``partials`` (a dict, tests only) receives the
    workspace: ``m``, ``l`` [B,S,H,n_splits] and ``acc``
    [B,S,H,n_splits,hd], fp32."""
    fn = _entry()
    b, s_q, h, hd = q.shape
    out = torch.empty_like(q)
    splits = -(-block_k * max_blocks // SPLIT_SPAN)  # of the table's width
    part_acc = torch.empty((b, s_q, h, splits, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, s_q, h, splits, 2), dtype=torch.float32,
                          device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale),
                 ptr(lens), ptr(tables), ptr(out), ptr(part_acc),
                 ptr(part_ml), _DTYPE_CODES[q.dtype],
                 _DTYPE_CODES[k.dtype], b, s_q, h, k.shape[2], hd, block_k,
                 max_blocks, n_pool_blocks, splits, int(verify), hd**-0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f'decode attention kernel launch failed '
                           f'(code {err})')
    if partials is not None:
        partials.update(m=part_ml[..., 0], l=part_ml[..., 1], acc=part_acc)
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
