"""The yardstick's arithmetic: the card's published peaks and the work a
kernel or a model step needs, computed from shapes alone.

Nothing here reads the program: a roofline share is this module's count
over a time the trace measured, so a change to a kernel cannot make the
count stale. Peaks are NVIDIA's data sheet for one H100 SXM (dense, no
sparsity), at its full 700 W power limit.
"""
from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def decode_attention_bytes(lens: Iterable[int], n_heads: int,
                           n_kv_heads: int, head_dim: int,
                           elem_bytes: int = 2) -> int:
    """Bytes one decode-attention call over a batch needs: each live K
    and V row read once, q read and the output written once, and one
    int32 length a row."""
    lens = list(lens)
    kv = sum(lens) * n_kv_heads * head_dim * 2 * elem_bytes
    q_out = 2 * len(lens) * n_heads * head_dim * elem_bytes
    return kv + q_out + 4 * len(lens)


def decode_attention_flops(lens: Iterable[int], n_heads: int,
                           head_dim: int) -> int:
    """Two products (q·K and p·V) over every live position of every
    query head."""
    return 4 * sum(lens) * n_heads * head_dim


def decode_attention_bound_s(lens: Iterable[int], n_heads: int,
                             n_kv_heads: int, head_dim: int,
                             elem_bytes: int = 2) -> Tuple[float, str]:
    """(least seconds, what sets it) for one decode-attention call."""
    lens = list(lens)
    t_bytes = decode_attention_bytes(lens, n_heads, n_kv_heads, head_dim,
                                     elem_bytes) / HBM_BYTES_PER_S
    t_ops = decode_attention_flops(lens, n_heads,
                                   head_dim) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps over ``s`` positions."""
    return s * (s + 1) // 2


def flash_forward_flops(b: int, s: int, h: int, d: int) -> int:
    """Causal attention forward: q·K and p·V over the kept pairs."""
    return 4 * b * h * d * causal_pairs(s)


def flash_backward_flops(b: int, s: int, h: int, d: int) -> int:
    """Causal attention backward: dV = pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K,
    dK = dSᵀ·Q, and q·K once more, since no attention matrix is kept:
    five products, 2.5 times the forward."""
    return 10 * b * h * d * causal_pairs(s)


def flash_forward_bound_s(b: int, s: int, h: int, d: int) -> float:
    """Least seconds of one causal forward in bf16 (it is bound by
    operations at every training shape: its inputs are read once)."""
    return flash_forward_flops(b, s, h, d) / PEAK_BF16_FLOPS


def dense_block_params(dim: int, n_heads: int, n_kv_heads: int,
                       head_dim: int, ffn_dim: int) -> int:
    """Matmul weights of one dense decoder block (norms left out)."""
    attn = dim * (n_heads + 2 * n_kv_heads) * head_dim + \
        n_heads * head_dim * dim
    return attn + 3 * dim * ffn_dim


def moe_block_active_params(dim: int, n_heads: int, n_kv_heads: int,
                            head_dim: int, ffn_dim: int, n_experts: int,
                            top_k: int) -> int:
    """Matmul weights one token passes through in a mixture-of-experts
    block: attention, the router and ``top_k`` experts."""
    attn = dim * (n_heads + 2 * n_kv_heads) * head_dim + \
        n_heads * head_dim * dim
    return attn + dim * n_experts + top_k * 3 * dim * ffn_dim


def serve_flops(active_params: int, n_layers: int, n_heads: int,
                head_dim: int, prompt_lens: Iterable[int],
                decode_positions: Iterable[int]) -> float:
    """Forward operations of serving: 2 per weight per token computed
    (prompt tokens prefilled and tokens decoded), plus causal attention
    over each prompt and over each decoded token's live positions.
    ``active_params`` counts the matmul weights a token passes through,
    the output head included and the embedding lookup not."""
    prompt_lens = list(prompt_lens)
    decode_positions = list(decode_positions)
    tokens = sum(prompt_lens) + len(decode_positions)
    attn = 4 * n_layers * n_heads * head_dim * (
        sum(causal_pairs(p) for p in prompt_lens) + sum(decode_positions))
    return 2.0 * active_params * tokens + attn


def train_flops_per_token(active_params: int, n_layers: int, n_heads: int,
                          head_dim: int, seq_len: int) -> float:
    """Forward and backward operations a trained token needs: 6 per
    weight it passes through, plus causal attention (forward 4·H·D a
    kept pair, backward 2.5 times that) averaged over the sequence.
    Recomputation and the dispatch of tokens to experts are not work
    the model needs, and are not counted."""
    per_seq_attn = (flash_forward_flops(1, seq_len, n_heads, head_dim) +
                    flash_backward_flops(1, seq_len, n_heads, head_dim))
    return 6.0 * active_params + n_layers * per_seq_attn / seq_len
