"""The plain reference: the configurations' equations in plain PyTorch.

Mistral-7B and Mixtral-8x7B blocks as their published configs describe
them: RMSNorm, split-half RoPE, causal grouped-query attention (query
head ``h`` reads KV head ``h // (H / Hkv)``), SwiGLU, and for Mixtral a
softmax router choosing ``top_k`` experts whose gates are renormalised.
The configuration file's ``assumed`` entries are followed where the
published config says nothing: a capacity of
``max(1, int(top_k · T / E · capacity_factor))`` tokens an expert,
slots given first choices before second ones in token order, tokens
past capacity dropped, and the Switch load-balancing loss
``E · Σ_e (share of assignments to e) · (mean probability of e)``.

Arithmetic is fp32 with TF32 off (:func:`exact_fp32`) on the weights
the benchmark made. Every product goes through an ``mm`` argument, so
the same code computed with its operands rounded to fp8
(:func:`fp8_mm`) is the control. This module imports nothing of the
program and takes nothing it made.
"""
import contextlib
import math
from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.weights import Dims

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    # The gradient passes the rounding straight through, as an fp8
    # training recipe's does (a cast to fp8 carries none).
    with torch.no_grad():
        scale = x.abs().amax(dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (rounded - x).detach()


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``a``'s rows and ``b``'s columns each scaled to
    float8_e4m3fn's range and rounded to it (the products and sums in
    fp32): the precision below bf16 that the control computes in."""
    return _to_fp8(a, -1) @ _to_fp8(b, -2)


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., T, H, D]; the first and second halves of D rotate as
    pairs (Mistral's ``rotate_half``)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv            # [T, D/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mm) -> torch.Tensor:
    """q [B, T, H, D], k/v [B, T, Hkv, D] → [B, T, H, D]."""
    b, t, h, d = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float('-inf'))
    return mm(torch.softmax(scores, dim=-1), v.transpose(1, 2)).transpose(
        1, 2)


def attention_sublayer(x: torch.Tensor, w: Dict[str, torch.Tensor],
                       d: Dims, positions: torch.Tensor,
                       mm) -> torch.Tensor:
    """x [B, T, dim] → x + attention (its residual added)."""
    b, t, _ = x.shape
    h = rms_norm(x, w['attn_norm'], d.norm_eps)
    q = mm(h, w['wq']).reshape(b, t, d.n_heads, d.head_dim)
    k = mm(h, w['wk']).reshape(b, t, d.n_kv_heads, d.head_dim)
    v = mm(h, w['wv']).reshape(b, t, d.n_kv_heads, d.head_dim)
    q, k = rope(q, positions, d.rope_theta), rope(k, positions,
                                                 d.rope_theta)
    attn = causal_attention(q, k, v, mm).reshape(b, t, -1)
    return x + mm(attn, w['wo'])


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, mm) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, w1)) * mm(x, w3), w2)


def dense_block(x, w, d: Dims, positions, mm) -> torch.Tensor:
    x = attention_sublayer(x, w, d, positions, mm)
    h = rms_norm(x, w['ffn_norm'], d.norm_eps)
    return x + swiglu(h, w['w1'], w['w3'], w['w2'], mm)


def capacity(d: Dims, tokens: int) -> int:
    return max(1, int(d.top_k * tokens / d.n_experts * d.capacity_factor))


def route(probs: torch.Tensor, d: Dims) -> (torch.Tensor, torch.Tensor):
    """probs [T, E] → (each token's top-k experts [T, K], whether its
    expert's capacity kept each choice [T, K])."""
    t = probs.shape[0]
    top_idx = torch.topk(probs, d.top_k, dim=-1).indices      # [T, K]
    onehot = torch.nn.functional.one_hot(top_idx, d.n_experts)  # [T,K,E]
    # Slot of each choice in its expert: first choices of all tokens in
    # token order, then second choices, and so on.
    order = onehot.transpose(0, 1).reshape(d.top_k * t, d.n_experts)
    before = (torch.cumsum(order, 0) - order).reshape(
        d.top_k, t, d.n_experts).transpose(0, 1)
    slot = (before * onehot).sum(-1)                          # [T, K]
    return top_idx, slot < capacity(d, t)


def moe_ffn(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dims,
            mm, routing=None, seen=None) -> (torch.Tensor, torch.Tensor):
    """h [T, dim] → (the experts' combined output [T, dim], aux loss).
    The router's product stays fp32, as the configuration keeps it.
    ``routing``, a diagnosis's, replaces the choices :func:`route`
    makes by given ones (``(top_idx, kept)``); ``seen``, a list, gets
    the choices :func:`route` made."""
    probs = torch.softmax(h @ w['router'], dim=-1)            # [T, E]
    own = route(probs.detach(), d)
    if seen is not None:
        seen.append(own)
    top_idx, kept = own if routing is None else (
        routing[0].to(h.device), routing[1].to(h.device))
    top_vals = probs.gather(-1, top_idx)
    gates = top_vals / top_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = torch.nn.functional.one_hot(top_idx, d.n_experts)  # [T,K,E]
    out = torch.zeros_like(h)
    for e in range(d.n_experts):
        for j in range(d.top_k):
            rows = torch.nonzero((top_idx[:, j] == e) & kept[:, j])[:, 0]
            if rows.numel() == 0:
                continue
            y = swiglu(h[rows], w['we1'][e], w['we3'][e], w['we2'][e], mm)
            out = out.index_add(0, rows, y * gates[rows, j, None])
    share = (onehot.sum(1).float() / d.top_k).mean(0)
    aux = d.n_experts * torch.sum(share * probs.mean(0))
    return out, aux


def moe_block(x, w, d: Dims, positions, mm, routing=None, seen=None):
    x = attention_sublayer(x, w, d, positions, mm)
    b, t, dim = x.shape
    h = rms_norm(x, w['ffn_norm'], d.norm_eps).reshape(b * t, dim)
    out, aux = moe_ffn(h, w, d, mm, routing, seen)
    return x + out.reshape(b, t, dim), aux


def layer_weights(params: Dict, i: int, dtype=torch.float32) -> Dict:
    return {name: leaf[i].to(dtype) for name, leaf in
            params['layers'].items()}


# ------------------------------------------------------------- serving


def served_logits(params: Dict, d: Dims, seqs: Sequence[torch.Tensor],
                  rows: Sequence[torch.Tensor], mms: Dict) -> Dict:
    """Teacher-forced logits of a dense model: for each sequence of ids
    its logits [len(rows), vocab] at positions ``rows``, once for each
    product in ``mms`` (name → mm). One layer's weights are made fp32 at
    a time, and every sequence passes it before the next."""
    hidden = {name: [params['tok_embedding'][s].float()[None]
                     for s in seqs] for name in mms}
    positions = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(d.n_layers):
        w = layer_weights(params, i)
        for name, mm in mms.items():
            hidden[name] = [dense_block(x, w, d, pos, mm)
                            for x, pos in zip(hidden[name], positions)]
        del w
    head = params['lm_head'].float()
    norm = params['out_norm'].float()
    return {name: [mm(rms_norm(x[0, r], norm, d.norm_eps), head)
                   for x, r in zip(hidden[name], rows)]
            for name, mm in mms.items()}


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a token's logit lies below the best
    logit at its position."""
    best = ref_logits.max(-1).values
    chosen = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return float((best - chosen).max())


# ------------------------------------------------------------ training


def moe_loss(params32: Dict, tokens: torch.Tensor, targets: torch.Tensor,
             d: Dims, mm, routing=None, seen=None) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``router_aux_coef`` times the
    layers' summed aux losses. Each block runs under ``checkpoint``,
    which changes memory and not values. ``routing`` (one entry a
    layer) and ``seen`` are :func:`moe_ffn`'s; ``seen`` gets each
    layer's choices in the forward pass and again in the recompute."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params32['tok_embedding'][tokens]
    auxes = []
    for i in range(d.n_layers):
        w = {n: leaf[i] for n, leaf in params32['layers'].items()}
        x, aux = checkpoint(moe_block, x, w, d, positions, mm,
                            None if routing is None else routing[i], seen,
                            use_reentrant=False)
        auxes.append(aux)
    x = rms_norm(x, params32['out_norm'], d.norm_eps)
    logits = mm(x, params32['lm_head'])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).mean() + d.router_aux_coef * torch.stack(
        auxes).sum()


def leaves(tree: Dict, prefix: str = '') -> List:
    """(path, tensor) of a param tree in sorted path order."""
    out = []
    for key in sorted(tree):
        path = f'{prefix}{key}'
        if isinstance(tree[key], dict):
            out += leaves(tree[key], path + '/')
        else:
            out.append((path, tree[key]))
    return out


def learning_rate(opt: Dict, count: int) -> float:
    """Linear warm-up from 0 over ``warmup_steps``, then cosine decay to
    0 at ``max(10 · warmup, 1000)``, read at the count before the
    step."""
    lr, warm = opt['learning_rate'], opt['warmup_steps']
    decay = max(10 * warm, 1000)
    if count < warm:
        return lr * count / warm
    t = min(count - warm, decay - warm)
    return lr * 0.5 * (1 + math.cos(math.pi * t / (decay - warm)))


def adamw_step(params: Dict, grads: Dict, state: Dict, opt: Dict) -> float:
    """One AdamW step after clipping the global norm, in fp32 on
    ``params`` and the moments stored in their leaves' dtype (the
    configuration's). Returns the pre-clip global norm."""
    g_leaves = dict(leaves(grads))
    norm = math.sqrt(sum(float((g * g).sum()) for g in g_leaves.values()))
    scale = 1.0 if norm < opt['grad_clip'] else opt['grad_clip'] / norm
    count = state['count'] + 1
    lr = learning_rate(opt, state['count'])
    b1, b2 = opt['beta1'], opt['beta2']
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    for path, p in leaves(params):
        g = g_leaves[path] * scale
        mu, nu = state['mu'][path], state['nu'][path]
        mu.copy_(b1 * mu.float() + (1 - b1) * g)
        nu.copy_(b2 * nu.float() + (1 - b2) * g * g)
        u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + 1e-8)
        p.copy_(p.float() - lr * (u + opt['weight_decay'] * p.float()))
    state['count'] = count
    return norm
