"""Mixtral-family mixture-of-experts decoder, with expert parallelism.

Counterpart of ``skypilot_tpu/models/moe.py``. The attention sublayer,
norms and RoPE are ``models/llama.py``'s (so ``flash_attention`` runs
the flash kernels); the dense FFN becomes a router and a SwiGLU per
expert:

* GShard top-k routing with a capacity per expert
  (``max(1, int(top_k · T / E · capacity_factor))`` slots), softmax in
  fp32, the kept gates renormalised, slots given k-major (every token's
  first choice before any second choice), tokens past capacity dropped
  (they ride the residual), and the Switch aux loss over all tokens;
* routing as the reference writes it: dense one-hot dispatch and
  combine einsums, ``dispatch`` in the model dtype against the tokens
  into [E, C, d], each expert's SwiGLU with fp32 products, ``combine``
  in fp32 back to [T, d].

The param tree is llama's without ``w1``/``w2``/``w3``, plus per layer
``router`` [d, E] (fp32), ``we1``/``we3`` [E, d, f] and ``we2`` [E, f, d].

On a training mesh (``mesh=``; ``models/train.py`` runs this model when
given a :class:`MoeConfig`) every rank holds its slices under
:func:`param_partition_specs`: its ``E/expert`` experts (each split over
fsdp), the router and attention replicated along 'expert'. Capacity and
the slot cumsum are global, as the reference's program over the whole
batch has them: each block gathers the normed rows of every batch rank
(:func:`parallel.mesh.gather_rows`), routes all ``B·S`` tokens in
row-major order, runs its experts on them, sums the experts' parts over
'expert' (forward sum, backward identity) and keeps its own rows. The
aux loss, a mean over the global batch, enters each batch rank's loss
share divided by the batch ranks, so the shares sum to it once. A
'model' axis inside the experts is not ported.
"""
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert capacity = top_k * tokens / n_experts * capacity_factor.
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


CONFIGS: Dict[str, MoeConfig] = {
    'mixtral-8x7b': MoeConfig(dim=4096, n_layers=32, n_heads=32,
                              n_kv_heads=8, ffn_dim=14336, n_experts=8,
                              top_k=2),
    'moe-debug': MoeConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=96, n_experts=4, top_k=2,
                           max_seq_len=128, remat=False),
}


# ------------------------------------------------------------------- init


def param_shapes(cfg: MoeConfig) -> Params:
    shapes = llama.param_shapes(cfg)
    layers = {k: v for k, v in shapes['layers'].items()
              if k not in ('w1', 'w2', 'w3')}
    L, e, d, f = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.ffn_dim
    layers.update(router=(L, d, e), we1=(L, e, d, f), we3=(L, e, d, f),
                  we2=(L, e, f, d))
    shapes['layers'] = layers
    return shapes


def param_partition_specs(cfg: MoeConfig) -> Params:
    """llama's specs without the dense FFN; the router over fsdp, the
    experts over 'expert' and, within an expert, Megatron-style."""
    specs = llama.param_partition_specs(cfg)
    layers = {k: v for k, v in specs['layers'].items()
              if k not in ('w1', 'w2', 'w3')}
    fsdp, model = mesh_lib.FSDP_AXIS, mesh_lib.MODEL_AXIS
    expert = mesh_lib.EXPERT_AXIS
    layers.update(router=(None, fsdp, None),
                  we1=(None, expert, fsdp, model),
                  we3=(None, expert, fsdp, model),
                  we2=(None, expert, model, fsdp))
    specs['layers'] = layers
    return specs


def init_params(cfg: MoeConfig, generator: torch.Generator, device='cpu',
                mesh: Optional[mesh_lib.Mesh] = None) -> Params:
    """Random params as ``llama.init_params`` draws them (normal(0,
    0.02), norms ones, leaf by leaf, a stacked leaf a layer at a time,
    this rank's slice of each draw on a ``mesh``); the router in fp32,
    every other leaf in the model dtype."""
    return llama.init_tree(
        param_shapes(cfg), param_partition_specs(cfg),
        lambda name: torch.float32 if name == 'router' else cfg.dtype,
        generator, device, mesh)


def check_mesh(cfg: MoeConfig, mesh: Optional[mesh_lib.Mesh]) -> None:
    """Raise on a mesh this port does not run the model on."""
    if mesh is None:
        return
    if mesh.size(mesh_lib.MODEL_AXIS) > 1:
        raise NotImplementedError(
            "a 'model' axis inside the experts is not ported to "
            'skypilot_tpu_torch yet (ROADMAP.md, queue 1)')
    if cfg.n_experts % mesh.size(mesh_lib.EXPERT_AXIS):
        raise ValueError(f'{cfg.n_experts} experts do not split over an '
                         f"'expert' axis of {mesh.size(mesh_lib.EXPERT_AXIS)}")


# ---------------------------------------------------------------- routing


def _capacity(cfg: MoeConfig, t: int) -> int:
    return max(1, int(cfg.top_k * t / cfg.n_experts * cfg.capacity_factor))


def _assign(probs: torch.Tensor, cfg: MoeConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [T, E] → (combine [T, E, C] fp32, the top-k one-hot
    [T, K, E] int): each token's top-k gates, renormalised, in the slots
    a k-major cumsum gives them, zero past capacity."""
    t, e = probs.shape
    k = cfg.top_k
    capacity = _capacity(cfg, t)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)          # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, e)           # [T, K, E]
    flat = onehot.transpose(0, 1).reshape(k * t, e)             # k-major
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, t, e).transpose(0, 1)
    within_cap = (pos < capacity) & (onehot == 1)
    slot = (pos * onehot).sum(-1)                               # [T, K]
    slot_onehot = (slot[..., None] == torch.arange(
        capacity, device=probs.device)).float()                # [T, K, C]
    keep = within_cap.any(-1).float()
    combine = torch.einsum('tke,tkc,tk,tk->tec', onehot.float(),
                           slot_onehot, gate_vals, keep)
    return combine, onehot


def _aux(probs: torch.Tensor, onehot: torch.Tensor,
         cfg: MoeConfig) -> torch.Tensor:
    """The Switch load-balancing loss: E · Σ_e (share of assignments to
    e) · (mean probability of e)."""
    frac_tokens = (onehot.sum(1) / cfg.top_k).mean(0)
    return cfg.n_experts * torch.sum(frac_tokens * probs.mean(0))


def _route(h: torch.Tensor, router: torch.Tensor, cfg: MoeConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [T, d] → (dispatch [T, E, C] bool, combine [T, E, C] fp32, aux):
    GShard top-k routing with per-expert capacity C."""
    probs = torch.softmax(h.float() @ router, dim=-1)
    combine, onehot = _assign(probs, cfg)
    return combine > 0.0, combine, _aux(probs, onehot, cfg)


def _experts(xin: torch.Tensor, we1: torch.Tensor, we3: torch.Tensor,
             we2: torch.Tensor, dtype) -> torch.Tensor:
    """xin [E, C, d] → [E, C, d] fp32: SwiGLU per expert, the products
    with fp32 accumulation (fp32 operands: a product of two model-dtype
    values is exact in fp32), the activation cast to the model dtype
    before ``we2``."""
    gate = torch.nn.functional.silu(
        torch.einsum('ecd,edf->ecf', xin.float(), we1.float()))
    up = torch.einsum('ecd,edf->ecf', xin.float(), we3.float())
    act = (gate * up).to(dtype)
    return torch.einsum('ecf,efd->ecd', act.float(), we2.float())


def _expert_sum(out: torch.Tensor, mesh: mesh_lib.Mesh) -> torch.Tensor:
    """The experts' parts of the layer output summed over 'expert'."""
    return mesh_lib.reduce_from(out, mesh, mesh_lib.EXPERT_AXIS)


def moe_ffn(h: torch.Tensor, layer: Params, cfg: MoeConfig,
            mesh: Optional[mesh_lib.Mesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B, S, d] → (out [B, S, d] in the model dtype, aux loss). On a
    ``mesh``: h is this rank's rows, routed among every batch rank's
    (see the module's docstring); ``layer``'s weights are gathered."""
    b, s, d = h.shape
    rows = h if mesh is None else mesh_lib.gather_rows(h, mesh)
    flat = rows.reshape(-1, d)
    probs = probs_x = torch.softmax(flat.float() @ layer['router'], dim=-1)
    if mesh is not None:
        # The expert region: each rank runs its experts, and its part of
        # the grads of the region's inputs is summed over 'expert'.
        probs_x = mesh_lib.copy_to(probs, mesh, mesh_lib.EXPERT_AXIS)
        flat = mesh_lib.copy_to(flat, mesh, mesh_lib.EXPERT_AXIS)
    combine, onehot = _assign(probs_x, cfg)
    aux = _aux(probs, onehot, cfg)
    if mesh is not None:
        n_local = layer['we1'].shape[0]
        first = mesh.coord(mesh_lib.EXPERT_AXIS) * n_local
        combine = combine[:, first:first + n_local]
    dispatch = combine > 0.0
    xin = torch.einsum('tec,td->ecd', dispatch.to(cfg.dtype), flat)
    xout = _experts(xin, layer['we1'], layer['we3'], layer['we2'],
                    cfg.dtype)
    out = torch.einsum('tec,ecd->td', combine, xout)
    if mesh is not None:
        out = _expert_sum(out, mesh).reshape(-1, s, d)
        out = out[mesh.batch_rows(out.shape[0])]
    return out.reshape(b, s, d).to(cfg.dtype), aux


# ---------------------------------------------------------------- forward


def _gathered(layer: Params, mesh: Optional[mesh_lib.Mesh]) -> Params:
    """A layer's fsdp slices gathered on a mesh: attention's as llama's,
    the router on its rows, each expert weight on its fsdp dim."""
    if mesh is None:
        return layer
    out = llama._gathered(layer, mesh, ('wq', 'wk', 'wv', 'wo'))  # pylint: disable=protected-access
    out['router'] = mesh_lib.gather_shards(layer['router'], mesh, 0)
    for name, dim in (('we1', 1), ('we3', 1), ('we2', 2)):
        out[name] = mesh_lib.gather_shards(layer[name], mesh, dim)
    return out


def _moe_block(cfg: MoeConfig, x: torch.Tensor, layer: Params,
               cos: torch.Tensor, sin: torch.Tensor, impl: Optional[str],
               mesh: Optional[mesh_lib.Mesh]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    layer = _gathered(layer, mesh)
    x, _, _ = llama.attn_sublayer(cfg, x, layer, cos, sin, impl, mesh)
    h = llama.rms_norm(x, layer['ffn_norm'], cfg.norm_eps)
    ffn_out, aux = moe_ffn(h, layer, cfg, mesh)
    return x + ffn_out, aux


def _hidden(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
            positions: Optional[torch.Tensor], impl: Optional[str],
            mesh: Optional[mesh_lib.Mesh]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens → (final normed hidden states, Σ aux · router_aux_coef).
    With ``cfg.remat`` and autograd on, each whole block runs under
    ``checkpoint``, whatever ``remat_policy`` says (the reference's
    ``jax.checkpoint`` over the block)."""
    check_mesh(cfg, mesh)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cos, sin = llama._rope_freqs(cfg, positions)  # pylint: disable=protected-access
    x = llama._embed(params, tokens, cfg, mesh)  # pylint: disable=protected-access
    names = sorted(params['layers'])
    per_layer = zip(*(params['layers'][n].unbind(0) for n in names))
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for weights in per_layer:
        args = (cfg, x, dict(zip(names, weights)), cos, sin, impl, mesh)
        x, aux = (checkpoint(_moe_block, *args, use_reentrant=False)
                  if remat else _moe_block(*args))
        auxes.append(aux)
    x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
    return x, torch.stack(auxes).sum() * cfg.router_aux_coef


def forward(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
            positions: Optional[torch.Tensor] = None,
            impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V] fp32, aux router loss · coef)."""
    x, aux = _hidden(params, tokens, cfg, positions, impl, None)
    return (x @ params['lm_head']).float(), aux


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: MoeConfig, impl: Optional[str] = None,
            mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the full logits (``ce_chunks``
    is not read, as in the reference) plus the aux loss. On a ``mesh``,
    ``tokens`` are this rank's rows and the result its share of the
    global loss (the shares of the batch ranks sum to it)."""
    x, aux = _hidden(params, tokens, cfg, None, impl, mesh)
    if mesh is not None:
        ce = llama._sharded_xent(  # pylint: disable=protected-access
            x, params['lm_head'], targets,
            dataclasses.replace(cfg, ce_chunks=1), mesh)
        return ce + aux / mesh.size(mesh_lib.BATCH_AXES)
    logits = (x @ params['lm_head']).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).mean() + aux
