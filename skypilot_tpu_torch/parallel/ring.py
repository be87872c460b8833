"""Ring attention: exact causal attention over a sequence-sharded axis.

Counterpart of ``skypilot_tpu/parallel/ring.py``. Each rank holds a
sequence shard of Q/K/V; the K/V blocks go round the ring of the
``seq`` ranks (``parallel/mesh.ppermute``: one send and one receive a
step, the backward sending the grads the other way) while each rank
folds every block into an online-softmax accumulator in fp32, so a rank
holds O(S/n · S/n) of scores at a time. Causality uses global
positions, the rank's index times the shard length.

The block products are plain ``torch`` einsums, as the reference's are
outside any Pallas kernel. The blocks travel at their ``Hkv`` width and
are repeated to ``H`` heads on arrival (the reference repeats before
the ring: the same values for 1/G of the traffic). Each fold runs under
``torch.utils.checkpoint`` when grads are on, so backward keeps only
the fold's inputs and recomputes its scores.

:func:`ring_attention_inner` works on this rank's shards;
:func:`ring_attention` takes the global tensors every rank holds, as
the reference's ``shard_map`` wrapper does.
"""
from typing import Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30


def _fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
          q_pos: torch.Tensor, kv_pos: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K/V block [B, Sl, H, D] into the running max m [B,H,S], sum l
    [B,H,S] and output acc [B,S,H,D] (fp32), with the reference's guards
    for rows every key of which is masked."""
    scale = q.shape[-1]**-0.5
    logits = torch.einsum('bshd,bthd->bhst', q.float(), k.float()) * scale
    mask = q_pos[:, None] >= kv_pos[None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) would be 1 on a fully masked row.
    safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
    p = torch.exp(logits - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    correction = torch.where(m == NEG_INF, 0.0, torch.exp(m - safe_m))
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum('bhst,bthd->bshd', p.to(q.dtype).float(), v.float())
    acc_new = acc * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def ring_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: mesh_lib.Mesh,
                         axis_name: str = mesh_lib.SEQ_AXIS) -> torch.Tensor:
    """This rank's attention output [B, Sl, H, D] (q's dtype) from its
    shards q [B, Sl, H, D] and k/v [B, Sl, Hkv, D]: shard ``i`` of the
    ``axis_name`` ranks holds positions ``[i·Sl, (i+1)·Sl)``. Every rank
    of the axis calls it."""
    n = mesh.size(axis_name)
    me = mesh.coord(axis_name)
    b, sl, h, d = q.shape
    rep = h // k.shape[2]
    q_pos = me * sl + torch.arange(sl, device=q.device)
    m = torch.full((b, h, sl), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (me - i) % n  # whose shard this rank holds at step i
        kv_pos = src * sl + torch.arange(sl, device=q.device)
        args = (q, attention_ops.repeat_kv(k_blk, rep),
                attention_ops.repeat_kv(v_blk, rep), m, l, acc, q_pos, kv_pos)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_fold, *args, use_reentrant=False)
        else:
            m, l, acc = _fold(*args)
        if i < n - 1:  # receive the previous rank's block
            k_blk, v_blk = mesh_lib.ppermute((k_blk, v_blk), mesh,
                                             axis_name)
    denom = torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: mesh_lib.Mesh, seq_axis: str = mesh_lib.SEQ_AXIS,
                   batch_axes: Union[str, Sequence[str]] = (
                       mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS),
                   head_axis: Optional[str] = mesh_lib.MODEL_AXIS
                   ) -> torch.Tensor:
    """Global q [B, S, H, D] and k/v [B, S, Hkv, D], the same on every
    rank → the global output on every rank. Each rank takes its shard
    under the reference's spec ``(batch_axes, seq_axis, head_axis,
    None)`` (S divisible by the seq axis), runs
    :func:`ring_attention_inner`, and the shards are gathered back;
    grads flow to the global inputs on every rank."""
    batch_axes = (batch_axes if isinstance(batch_axes, str)
                  else tuple(batch_axes))
    spec = (batch_axes, seq_axis, head_axis, None)
    q, k, v = (mesh_lib.shard(t, mesh, spec) for t in (q, k, v))
    out = ring_attention_inner(q, k, v, mesh, seq_axis)
    return mesh_lib.unshard(out, mesh, spec)
