"""Llama-3-family decoder in plain PyTorch: forward and training loss.

Counterpart of ``skypilot_tpu/models/llama.py``. The parameter layout is
the reference's, so weights bridge by plain copy
(``models/convert.py``): a dict with ``tok_embedding [V, D]``,
``layers`` (each weight stacked ``[L, in, out]`` and applied as
``x @ W``), ``out_norm [D]`` and ``lm_head [D, V]``.

Numerics follow the reference step for step: bf16 activations, RMSNorm
statistics in fp32 cast to the model dtype *before* the weight multiply,
split-half RoPE in fp32, SwiGLU in fp32 cast before ``w2``, and the
lm_head product in the model dtype *then* cast to fp32.

The seven per-layer weight GEMMs go through :func:`quant_mm` /
:func:`quant_mms`, which run int8 weights (``ops/quant.QuantizedTensor``,
made by ``decode.quantize_params`` for serving) on the int8 GEMM and a
plain tensor as ``x @ w``; ``lm_head`` and the embedding stay in the
model dtype, as in the reference.

Training: :func:`loss_fn` (mean next-token cross-entropy, optionally in
checkpointed sequence chunks), per-block rematerialisation through
``torch.utils.checkpoint`` under the reference's five policies (see
:func:`remat_block`), and the flash-attention kernels of
``ops/flash_attention.py`` when ``flash_attention`` is set — for prefill
too, as in the reference. ``impl`` ('kernel' or 'plain')
picks the flash kernels or their plain twins; None takes the kernels on
CUDA tensors.
"""
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils.checkpoint import checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.ops import quant

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # Remat each block's activations (trade FLOPs for device memory).
    remat: bool = True
    # What backward keeps of a block (REMAT_POLICIES): 'full' only its
    # input; 'dots' also the wq/wk/wv/wo/w1/w3 outputs; 'ffn' the w1 and
    # w3 outputs; 'ffn1' the w1 output; 'attn' the attention output.
    remat_policy: str = 'full'
    # Causal attention through the flash kernels (training and prefill).
    flash_attention: bool = False
    # Cross-entropy in this many checkpointed sequence chunks, so the
    # [B, S, vocab] logits never exist at once (1 = unchunked).
    ce_chunks: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        emb = self.vocab_size * self.dim
        per_layer = (
            self.dim * self.n_heads * self.head_dim +
            2 * self.dim * self.n_kv_heads * self.head_dim +
            self.n_heads * self.head_dim * self.dim +
            3 * self.dim * self.ffn_dim +
            2 * self.dim)
        return 2 * emb + self.n_layers * per_layer + self.dim

    def flops_per_token(self, seq_len: int) -> float:
        """Approx fwd+bwd FLOPs per token (6N + attention term)."""
        n = self.num_params() - self.vocab_size * self.dim  # non-embedding
        attn = 12 * self.n_layers * self.dim * seq_len  # causal ~ s/2 * 2
        return 6 * n + attn


# The reference's published shapes and small test/bench configs.
CONFIGS: Dict[str, LlamaConfig] = {
    'llama3-8b': LlamaConfig(),
    'llama3-70b': LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, ffn_dim=28672),
    'llama3-1b': LlamaConfig(dim=2048, n_layers=16, n_heads=32,
                             n_kv_heads=8, ffn_dim=8192,
                             vocab_size=128256),
    'bench-160m': LlamaConfig(vocab_size=32768, dim=1024, n_layers=12,
                              n_heads=16, n_kv_heads=8, ffn_dim=4096,
                              max_seq_len=2048),
    'bench-1b': LlamaConfig(vocab_size=32768, dim=2048, n_layers=16,
                            n_heads=16, n_kv_heads=8, ffn_dim=8192,
                            max_seq_len=2048, ce_chunks=8),
    'bench-cpu': LlamaConfig(vocab_size=2048, dim=256, n_layers=3,
                             n_heads=4, n_kv_heads=2, ffn_dim=768,
                             max_seq_len=256, remat=False),
    'debug': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                         remat=False),
}


# ------------------------------------------------------------------- init


def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """The param tree's shapes (same structure as the params)."""
    hd = cfg.head_dim
    L = cfg.n_layers
    return {
        'tok_embedding': (cfg.vocab_size, cfg.dim),
        'layers': {
            'attn_norm': (L, cfg.dim),
            'wq': (L, cfg.dim, cfg.n_heads * hd),
            'wk': (L, cfg.dim, cfg.n_kv_heads * hd),
            'wv': (L, cfg.dim, cfg.n_kv_heads * hd),
            'wo': (L, cfg.n_heads * hd, cfg.dim),
            'ffn_norm': (L, cfg.dim),
            'w1': (L, cfg.dim, cfg.ffn_dim),
            'w3': (L, cfg.dim, cfg.ffn_dim),
            'w2': (L, cfg.ffn_dim, cfg.dim),
        },
        'out_norm': (cfg.dim,),
        'lm_head': (cfg.dim, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device='cpu') -> Params:
    """Random params: normal(0, 0.02) in the model dtype from
    ``generator`` (which must live on ``device``), norms set to ones.
    Draws differ from the reference's ``jax.random`` stream; parity
    tests bridge the reference's own params instead."""

    def init(name, shape):
        if name.endswith('norm'):
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, 0.02, generator=generator)
        return w.to(cfg.dtype)

    shapes = param_shapes(cfg)
    params = {name: init(name, shape) for name, shape in shapes.items()
              if name != 'layers'}
    params['layers'] = {name: init(name, shape)
                        for name, shape in shapes['layers'].items()}
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {name: w[i] for name, w in params['layers'].items()}


# ---------------------------------------------------------------- forward


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def _rope_freqs(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = cfg.head_dim
    exponent = (torch.arange(0, hd, 2, dtype=torch.float32,
                             device=positions.device) / hd)
    inv_freq = 1.0 / (cfg.rope_theta**exponent)
    angles = positions[..., None].float() * inv_freq     # [B?, S, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [S, hd/2] or [B, S, hd/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv(cfg: LlamaConfig, x: torch.Tensor, layer: Params, cos: torch.Tensor,
        sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Norm → Q/K/V projections → RoPE: [B,S,H,hd], [B,S,Hkv,hd] x2."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer['attn_norm'], cfg.norm_eps)
    q, k, v = quant_mms(h, layer['wq'], layer['wk'], layer['wv'])
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def quant_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that dispatches on int8-quantized weights (the serving
    path, ``ops/quant.py``); a plain tensor is ``x @ w``. The
    reference's ``quant_mm``."""
    if isinstance(w, quant.QuantizedTensor):
        return quant.int8_matmul(x, w)
    return x @ w


def quant_mms(x: torch.Tensor, *ws) -> list:
    """``[quant_mm(x, w) for w in ws]``, quantising x's rows once when
    every weight is int8 (the same rows and scales as separate calls, so
    the same bits, in fewer launches)."""
    if all(isinstance(w, quant.QuantizedTensor) for w in ws):
        return quant.int8_matmuls(x, ws)
    return [quant_mm(x, w) for w in ws]


def full_sequence_attention(cfg: LlamaConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            impl: Optional[str] = None) -> torch.Tensor:
    """The config-selected causal attention for full (non-cached)
    sequences: flash kernels (or their twins, see ``impl``) when
    ``cfg.flash_attention``, else the grouped einsum. One place for the
    train and prefill paths."""
    if cfg.flash_attention:
        return flash_ops.flash_attention(q, k, v, True, impl)
    return attention_ops.gqa_attention(q, k, v, causal=True)


def _attention_out(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                   cos: torch.Tensor, sin: torch.Tensor,
                   impl: Optional[str]) -> torch.Tensor:
    """Norm → QKV → RoPE → causal attention: the attention output
    [B, S, H·hd] before ``wo`` (what the ``'attn'`` policy keeps)."""
    return _attention(cfg, x, layer, cos, sin, impl)[0]


def _attention(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
               cos: torch.Tensor, sin: torch.Tensor, impl: Optional[str]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q, k, v = qkv(cfg, x, layer, cos, sin)
    attn = full_sequence_attention(cfg, q, k, v, impl)
    return attn.reshape(b, s, cfg.n_heads * cfg.head_dim), k, v


def attn_sublayer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                  cos: torch.Tensor, sin: torch.Tensor,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Norm → QKV → RoPE → causal attention → residual. Returns
    (x, k, v) so prefill seeds the KV cache from the same code."""
    attn, k, v = _attention(cfg, x, layer, cos, sin, impl)
    return _attn_residual(cfg, x, attn, layer), k, v


def _attn_residual(cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                   layer: Params) -> torch.Tensor:
    return x + quant_mm(attn, layer['wo']).to(cfg.dtype)


def ffn_sublayer(cfg: LlamaConfig, x: torch.Tensor,
                 layer: Params) -> torch.Tensor:
    """Norm → SwiGLU (fp32) → residual."""
    h = rms_norm(x, layer['ffn_norm'], cfg.norm_eps)
    w1_out, w3_out = quant_mms(h, layer['w1'], layer['w3'])
    gate = torch.nn.functional.silu(w1_out.float())
    up = w3_out.float()
    down = quant_mm((gate * up).to(cfg.dtype), layer['w2'])
    return x + down.to(cfg.dtype)


def _block(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
           cos: torch.Tensor, sin: torch.Tensor,
           impl: Optional[str]) -> torch.Tensor:
    x, _, _ = attn_sublayer(cfg, x, layer, cos, sin, impl)
    return ffn_sublayer(cfg, x, layer)


def _after_attention(cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                     layer: Params) -> torch.Tensor:
    return ffn_sublayer(cfg, _attn_residual(cfg, x, attn, layer), layer)


REMAT_POLICIES = ('full', 'dots', 'ffn', 'ffn1', 'attn')
# The layer weights whose GEMM outputs a GEMM-saving policy keeps: what
# the reference's jax.checkpoint_policies keep and its backward reads.
# 'dots' (dots_with_no_batch_dims_saveable) leaves out w2, whose output
# the backward never reads, so XLA drops it; 'ffn' and 'ffn1' are
# save_only_these_names over the w1/w3 outputs.
SAVED_GEMMS = {'dots': ('wq', 'wk', 'wv', 'wo', 'w1', 'w3'),
               'ffn': ('w1', 'w3'),
               'ffn1': ('w1',)}


def _check_remat(cfg: LlamaConfig) -> None:
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f'unknown remat_policy: {cfg.remat_policy!r} '
                         "(expected 'full', 'dots', 'ffn', 'ffn1' or 'attn')")


def _saved_gemms_context(weights):
    """Selective-checkpoint contexts that keep the output of every
    ``aten.mm`` whose second operand lies in one of ``weights``'
    storages (``x @ w`` on a [B, S, in] x reaches the dispatcher as an
    ``mm`` of its [B·S, in] fold) and recompute everything else."""
    storages = {w.untyped_storage().data_ptr() for w in weights}

    def policy(ctx, op, *args, **kwargs):
        del ctx, kwargs
        if (op is torch.ops.aten.mm.default and
                args[1].untyped_storage().data_ptr() in storages):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def remat_block(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                cos: torch.Tensor, sin: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """One decoder block under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy``. Backward keeps exactly the reference's
    residuals: the block input, plus the GEMM outputs of
    :data:`SAVED_GEMMS` (selective checkpointing) or, for ``'attn'``,
    the attention output (the block split at it into two checkpointed
    segments). Everything else is recomputed, the flash forward under
    every policy, as the reference recomputes it (it never keeps the
    LSE). The policies change memory and recompute, never values."""
    policy = cfg.remat_policy
    if policy == 'attn':
        attn = checkpoint(_attention_out, cfg, x, layer, cos, sin, impl,
                          use_reentrant=False)
        return checkpoint(_after_attention, cfg, x, attn, layer,
                          use_reentrant=False)
    kwargs = {}
    if policy in SAVED_GEMMS:
        kwargs['context_fn'] = functools.partial(
            _saved_gemms_context, [layer[n] for n in SAVED_GEMMS[policy]])
    return checkpoint(_block, cfg, x, layer, cos, sin, impl,
                      use_reentrant=False, **kwargs)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   positions: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """tokens [B, S] → final normed hidden states [B, S, dim].

    With ``cfg.remat`` and autograd on, each block runs under
    :func:`remat_block`. The stacked layer weights are unbound once, so
    their gradients come back as one stack instead of one full-size
    tensor per layer."""
    _check_remat(cfg)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)
    cos, sin = _rope_freqs(cfg, positions)
    x = params['tok_embedding'][tokens.long()].to(cfg.dtype)
    names = sorted(params['layers'])
    per_layer = zip(*(params['layers'][n].unbind(0) for n in names))
    block = (remat_block if cfg.remat and torch.is_grad_enabled()
             else _block)
    for weights in per_layer:
        x = block(cfg, x, dict(zip(names, weights)), cos, sin, impl)
    return rms_norm(x, params['out_norm'], cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab] float32 (the lm_head
    product in the model dtype, then cast)."""
    x = forward_hidden(params, tokens, cfg, positions)
    return (x @ params['lm_head']).float()


# ------------------------------------------------------------------- loss


def _xent_from_logits(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Summed (not mean) next-token cross-entropy, fp32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).sum()


def _chunk_xent(x: torch.Tensor, lm_head: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    return _xent_from_logits((x @ lm_head).float(), targets)


def chunked_cross_entropy(x: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor,
                          num_chunks: int) -> torch.Tensor:
    """Mean CE over [B, S] without ever holding [B, S, vocab]: each
    sequence chunk's lm_head product and softmax run under
    ``checkpoint``, so backward recomputes the chunk's logits. Chunk
    sums add up in order, in fp32, as the reference's scan does."""
    b, s, _ = x.shape
    if s % num_chunks:
        raise ValueError(f'seq_len {s} does not split into {num_chunks} '
                         'cross-entropy chunks')
    c = s // num_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        part = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_xent, x[:, part], lm_head,
                                   targets[:, part], use_reentrant=False)
    return total / (b * s)


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LlamaConfig, impl: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (targets = tokens shifted by the
    caller), a scalar fp32 tensor."""
    x = forward_hidden(params, tokens, cfg, impl=impl)
    if cfg.ce_chunks > 1:
        return chunked_cross_entropy(x, params['lm_head'], targets,
                                     cfg.ce_chunks)
    logits = (x @ params['lm_head']).float()
    return _xent_from_logits(logits, targets) / targets.numel()
