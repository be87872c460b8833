"""Flash attention for training: three CUDA kernels, plain twins, autograd.

Counterpart of ``skypilot_tpu/ops/flash_attention.py``. Three kernels
(see each source's header for the design and what bounds it):

* :func:`flash_forward_kernel` replaces the Pallas ``_flash_kernel``:
  q [B,S,H,D], k/v [B,S,Hkv,D] → (out [B,S,H,D] in q's dtype, fp32 LSE
  [B,H,S]). bf16 runs the wgmma kernel of ``csrc/flash_forward_wgmma.cu``,
  fp32 the CUDA-core body of ``csrc/flash_attention.cu``;
* :func:`flash_bwd_dq_kernel` replaces ``_flash_bwd_dq_kernel``;
* :func:`flash_bwd_dkv_kernel` replaces ``_flash_bwd_dkv_kernel``,
  without expanding K/V to H heads. bf16 runs the wgmma kernels of
  ``csrc/flash_backward_wgmma.cu``, fp32 the CUDA-core bodies of
  ``csrc/flash_attention.cu`` (:func:`kernel_entry` says which).

Each has a plain PyTorch twin (:func:`flash_forward_plain`,
:func:`flash_backward_plain`) in fp32 throughout. :class:`FlashAttention`
ties a forward to its backward; :func:`flash_attention` takes the plain
twins only for CPU tensors or when the caller asks for ``'plain'``. For
a CUDA tensor it launches the kernels or raises: there is no fallback.

Every kernel wrapper counts its launches in a plain integer attribute
(``flash_forward_kernel.launches``), so a run can show that the training
path went through the kernels.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import cuda_build

NEG_INF = -1e30
IMPLS = ('kernel', 'plain')
# Limits of the CUDA kernels (csrc/flash_*.cu).
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PASSES = ('forward', 'dq', 'dkv')
# Launcher name → (library in cuda_build.SOURCES, C symbol, pointer
# arguments before the sizes).
ENTRIES = {
    'forward': ('flash_attention', 'skytorch_flash_forward', 5),
    'dq': ('flash_attention', 'skytorch_flash_bwd_dq', 7),
    'dkv': ('flash_attention', 'skytorch_flash_bwd_dkv', 8),
    'forward_wgmma': ('flash_forward_wgmma', 'skytorch_flash_forward_wgmma',
                      5),
    'dq_wgmma': ('flash_backward_wgmma', 'skytorch_flash_bwd_dq_wgmma', 7),
    'dkv_wgmma': ('flash_backward_wgmma', 'skytorch_flash_bwd_dkv_wgmma',
                  8)}


# ------------------------------------------------------------------ plain


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scaled logits [B, Hkv, G, S, S]; query head kv*G + r rides
    in group slot (kv, r), masked entries at NEG_INF."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).float()
    logits = torch.einsum('bskgd,btkd->bkgst', qg, k.float()) * d**-0.5
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = torch.where(pos[:, None] >= pos[None, :], logits, NEG_INF)
    return logits


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the forward kernel: (out [B,S,H,D] in q's dtype, fp32
    log-normaliser LSE [B,H,S])."""
    b, s, h, d = q.shape
    logits = _scores(q, k, causal)
    lse = torch.logsumexp(logits, dim=-1)                  # [B,Hkv,G,S]
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum('bkgst,btkd->bskgd', probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def row_dot(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, [B,S,H,D] → [B,H,S] (the reference
    computes it outside its kernels too). The products are formed in
    place in an fp32 copy of dO, exact for bf16 inputs; an einsum over
    two fp32 copies took 2.5x as long on the card."""
    prod = dout.to(torch.float32, copy=True).mul_(out)
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Twin of the two backward kernels: P = exp(scale·qkᵀ − L),
    dS = P ⊙ (dO·Vᵀ − D); dq = scale·dS·K, dk = scale·dSᵀ·Q, dv = Pᵀ·dO,
    the query heads of a group summed into their kv head."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    probs = torch.exp(_scores(q, k, causal) -
                      lse.reshape(b, hkv, g, s)[..., None])
    do = dout.reshape(b, s, hkv, g, d).float()
    dsum = row_dot(dout, out).reshape(b, hkv, g, s)
    dv = torch.einsum('bkgst,bskgd->btkd', probs, do)
    dp = torch.einsum('bskgd,btkd->bkgst', do, v.float())
    ds = probs * (dp - dsum[..., None])
    dq = torch.einsum('bkgst,btkd->bskgd', ds, k.float()) * d**-0.5
    dk = torch.einsum('bkgst,bskgd->btkd', ds,
                      q.reshape(b, s, hkv, g, d).float()) * d**-0.5
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ----------------------------------------------------------------- kernel


def _operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with the 16-byte-aligned base the kernels' vector
    loads need."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError('flash attention kernel: tensor base is not '
                         '16-byte aligned')
    return t


def _check(q, k, v, *rest):
    tensors = (q, k, v) + rest
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError('flash attention kernel: every tensor must be on '
                         'the same CUDA device')
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f'q must be [B,S,H,D] and k/v matching '
                         f'[B,S,Hkv,D]; got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or (
            h % k.shape[2]):
        raise ValueError(f'q {tuple(q.shape)} does not fit k/v '
                         f'{tuple(k.shape)}')
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or (
            v.dtype != q.dtype):
        raise ValueError(f'flash attention kernel takes float32 or '
                         f'bfloat16 q/k/v of one dtype, got {q.dtype}/'
                         f'{k.dtype}/{v.dtype}')
    if d not in HEAD_DIMS:
        raise ValueError(f'flash attention kernel takes head_dim in '
                         f'{HEAD_DIMS}, got {d}')


def kernel_entry(kernel_pass: str, dtype: torch.dtype) -> str:
    """The launcher (a key of :data:`ENTRIES`) that a pass ('forward',
    'dq' or 'dkv') calls, by dtype alone: the wgmma kernels for bf16,
    the CUDA-core bodies of ``csrc/flash_attention.cu`` for fp32. Never
    a fallback after a failure: a refused launch raises."""
    if kernel_pass not in PASSES or dtype not in _DTYPE_CODES:
        raise ValueError(f'no flash attention kernel for pass '
                         f'{kernel_pass!r} and dtype {dtype}')
    return (f'{kernel_pass}_wgmma' if dtype == torch.bfloat16 else
            kernel_pass)


@functools.lru_cache(maxsize=None)
def _entries():
    """The C launchers (the three libraries built together and loaded at
    first use), typed for ctypes: pointers and the stream as c_void_p,
    sizes as c_int."""
    libs = sorted({lib for lib, _, _ in ENTRIES.values()})
    cuda_build.build(libs)
    sizes = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fns = {}
    for name, (lib, symbol, n_ptrs) in ENTRIES.items():
        fn = fns[name] = getattr(cuda_build.load(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + sizes
    return fns


def _launch(kernel_pass: str, tensors, q, k, causal: bool) -> None:
    name = kernel_entry(kernel_pass, q.dtype)
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entries()[name](*(t.data_ptr() for t in tensors),
                               _DTYPE_CODES[q.dtype], b, s, h, k.shape[2],
                               d, int(causal), d**-0.5, stream)
    if err != 0:
        raise RuntimeError(f'flash attention {name} kernel launch failed '
                           f'(code {err})')


def flash_forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA flash forward → (out [B,S,H,D], fp32 LSE [B,H,S]). Replaces
    the Pallas ``_flash_kernel`` (skypilot_tpu/ops/flash_attention.py):
    the wgmma kernel for bf16, the CUDA-core kernel for fp32."""
    _check(q, k, v)
    q, k, v = _operand(q), _operand(k), _operand(v)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch('forward', (q, k, v, out, lse), q, k, causal)
    flash_forward_kernel.launches += 1
    return out, lse


flash_forward_kernel.launches = 0


def _bwd_operands(q, k, v, dout, lse, dsum):
    _check(q, k, v, dout, lse, dsum)
    b, s, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f'dout must match q {tuple(q.shape)} {q.dtype}, '
                         f'got {tuple(dout.shape)} {dout.dtype}')
    for name, t in (('lse', lse), ('dsum', dsum)):
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f'{name} must be fp32 [B,H,S]={(b, h, s)}, '
                             f'got {t.dtype} {tuple(t.shape)}')
    return tuple(_operand(t) for t in (q, k, v, dout, lse, dsum))


def flash_bwd_dq_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        dsum: torch.Tensor, causal: bool = True
                        ) -> torch.Tensor:
    """CUDA FA-2 dq pass → dq [B,S,H,D]. Replaces the Pallas
    ``_flash_bwd_dq_kernel``: the wgmma kernel for bf16, the CUDA-core
    kernel for fp32."""
    q, k, v, dout, lse, dsum = _bwd_operands(q, k, v, dout, lse, dsum)
    dq = torch.empty_like(q)
    _launch('dq', (q, k, v, dout, lse, dsum, dq), q, k, causal)
    flash_bwd_dq_kernel.launches += 1
    return dq


flash_bwd_dq_kernel.launches = 0


def flash_bwd_dkv_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, lse: torch.Tensor,
                         dsum: torch.Tensor, causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA FA-2 dk/dv pass → (dk, dv [B,S,Hkv,D]), the group's query
    heads summed in the kernel. Replaces the Pallas
    ``_flash_bwd_dkv_kernel``: the wgmma kernel for bf16, the CUDA-core
    kernel for fp32."""
    q, k, v, dout, lse, dsum = _bwd_operands(q, k, v, dout, lse, dsum)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('dkv', (q, k, v, dout, lse, dsum, dk, dv), q, k, causal)
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


flash_bwd_dkv_kernel.launches = 0

KERNELS = (flash_forward_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# --------------------------------------------------------------- dispatch


def resolved_path(device, impl: Optional[str] = None) -> str:
    """Which implementation runs for tensors on ``device``: 'kernel' or
    'plain' (CPU tensors, or ``impl='plain'``)."""
    if impl is not None and impl not in IMPLS:
        raise ValueError(f'flash attention impl must be one of {IMPLS}, '
                         f'got {impl!r}')
    device = torch.device(device)
    if impl == 'plain' or device.type == 'cpu':
        return 'plain'
    if device.type != 'cuda':
        raise ValueError(f'no flash attention kernel for {device}')
    return 'kernel'


class FlashAttention(torch.autograd.Function):
    """Flash attention with its FA-2 backward: the forward saves
    (q, k, v, out, lse); the backward recomputes P from the LSE (the
    reference's ``jax.custom_vjp`` ``_fwd``/``_bwd``)."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, q, k, v, causal, impl):
        ctx.plain = resolved_path(q.device, impl) == 'plain'
        if ctx.plain:
            out, lse = flash_forward_plain(q, k, v, causal)
        else:
            out, lse = flash_forward_kernel(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = flash_backward_plain(q, k, v, out, lse, dout,
                                              ctx.causal)
        else:
            dsum = row_dot(dout, out)
            dq = flash_bwd_dq_kernel(q, k, v, dout, lse, dsum, ctx.causal)
            dk, dv = flash_bwd_dkv_kernel(q, k, v, dout, lse, dsum,
                                          ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Drop-in for ``attention.gqa_attention`` on full sequences: q
    [B,S,H,D], k/v [B,S,Hkv,D] → [B,S,H,D], differentiable. Any S (the
    kernels mask the tail)."""
    return FlashAttention.apply(q, k, v, causal, impl)
