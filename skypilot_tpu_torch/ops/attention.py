"""GQA causal attention in plain PyTorch: the prefill attention.

Counterpart of ``skypilot_tpu/ops/attention.py`` (``repeat_kv``,
``gqa_attention``, and ``ring_attention``, the hook into
``parallel/ring.py``). Serving configs leave ``flash_attention`` off, so the
reference's prefill runs this grouped einsum too; numerics follow it:
fp32 logits and softmax, probabilities cast to the query dtype before
the PV product, fp32 accumulation, output in the query dtype.
"""
import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] → [B, S, Hkv*n_rep, D] (GQA key/value head fan-out)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,Skv,Hkv,D] → [B,S,H,D].

    Grouped contraction: query head ``kv*G + r`` rides in group slot
    ``(kv, r)`` (the ``repeat_kv`` order) and the expanded K/V are never
    materialised. ``q_offset`` places the queries inside the kv sequence.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    # fp32 operands: bf16 products are exact in fp32, so this is the
    # reference's preferred_element_type=float32 contraction.
    logits = torch.einsum('bskgd,btkd->bkgst', qg.float(),
                          k.float()) * d**-0.5
    if causal:
        skv = k.shape[1]
        q_pos = torch.arange(s, device=q.device) + q_offset
        kv_pos = torch.arange(skv, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum('bkgst,btkd->bskgd', probs.float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str) -> torch.Tensor:
    """Dispatch to the sequence-parallel ring over ``mesh``'s
    ``axis_name``: q/k/v are this rank's sequence shards (see
    ``parallel/ring.ring_attention_inner``). Without a mesh there is no
    ring to run on, as an unbound axis name in the reference."""
    if mesh is None:
        raise ValueError(f'ring attention needs a mesh with a '
                         f'{axis_name!r} axis (unbound axis name: '
                         f'{axis_name})')
    from skypilot_tpu_torch.parallel import ring
    return ring.ring_attention_inner(q, k, v, mesh, axis_name)
