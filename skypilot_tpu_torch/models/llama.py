"""Llama-3-family decoder in plain PyTorch (the serving forward).

Counterpart of ``skypilot_tpu/models/llama.py``. The parameter layout is
the reference's, so weights bridge by plain copy
(``models/convert.py``): a dict with ``tok_embedding [V, D]``,
``layers`` (each weight stacked ``[L, in, out]`` and applied as
``x @ W``), ``out_norm [D]`` and ``lm_head [D, V]``.

Numerics follow the reference step for step: bf16 activations, RMSNorm
statistics in fp32 cast to the model dtype *before* the weight multiply,
split-half RoPE in fp32, SwiGLU in fp32 cast before ``w2``, and the
lm_head product in the model dtype *then* cast to fp32. Training (remat,
loss, flash attention) belongs to a later slice.
"""
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import attention as attention_ops

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
                            max_seq_len=2048),
    'bench-cpu': LlamaConfig(vocab_size=2048, dim=256, n_layers=3,
                             n_heads=4, n_kv_heads=2, ffn_dim=768,
                             max_seq_len=256),
    'debug': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=128, max_seq_len=128),
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
    q = (h @ layer['wq']).reshape(b, s, cfg.n_heads, hd)
    k = (h @ layer['wk']).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ layer['wv']).reshape(b, s, cfg.n_kv_heads, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_sublayer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                  cos: torch.Tensor, sin: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Norm → QKV → RoPE → causal attention → residual. Returns
    (x, k, v) so prefill seeds the KV cache from the same code."""
    b, s, _ = x.shape
    q, k, v = qkv(cfg, x, layer, cos, sin)
    attn = attention_ops.gqa_attention(q, k, v, causal=True)
    attn = attn.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return x + (attn @ layer['wo']).to(cfg.dtype), k, v


def ffn_sublayer(cfg: LlamaConfig, x: torch.Tensor,
                 layer: Params) -> torch.Tensor:
    """Norm → SwiGLU (fp32) → residual."""
    h = rms_norm(x, layer['ffn_norm'], cfg.norm_eps)
    gate = torch.nn.functional.silu((h @ layer['w1']).float())
    up = (h @ layer['w3']).float()
    down = (gate * up).to(cfg.dtype) @ layer['w2']
    return x + down.to(cfg.dtype)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   positions: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """tokens [B, S] → final normed hidden states [B, S, dim]."""
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)
    cos, sin = _rope_freqs(cfg, positions)
    x = params['tok_embedding'][tokens.long()].to(cfg.dtype)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        x, _, _ = attn_sublayer(cfg, x, layer, cos, sin)
        x = ffn_sublayer(cfg, x, layer)
    return rms_norm(x, params['out_norm'], cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab] float32 (the lm_head
    product in the model dtype, then cast)."""
    x = forward_hidden(params, tokens, cfg, positions)
    return (x @ params['lm_head']).float()
