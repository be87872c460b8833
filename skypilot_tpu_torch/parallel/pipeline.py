"""Pipeline parallelism: GPipe over a 'stage' mesh axis.

Counterpart of ``skypilot_tpu/parallel/pipeline.py``. The decoder layers
are stacked ``[L, ...]`` and split over the ``stage`` ranks (``L/S``
layers a stage); microbatches go stage to stage by point-to-point sends
(``Mesh.ppermute``), fill-drain: ``M + S - 1`` ticks for ``M``
microbatches over ``S`` stages. The reference computes every stage at
every tick, on zeros in the bubble; here a stage computes only the
microbatches it holds (the same values, ``M`` passes a stage instead of
``M + S - 1``). Backward runs the reverse schedule: at each tick a
stage backpropagates one microbatch's cotangent through the graph its
forward kept (each block under ``torch.utils.checkpoint`` when
``cfg.remat`` is set, so that is a recompute) and sends the input's
cotangent to the stage before it.

Composes with data parallelism: the mesh is ``('data', 'stage')``,
stage innermost; each microbatch's rows split over 'data' (the
reference's ``P(None, 'data')``). Embedding, final norm, head and
cross-entropy run outside the pipeline, replicated on every stage: the
last stage's outputs become every stage's (forward sum of the masked
outputs, backward identity), the embedding feeds stage 0 (its grad, the
transpose of the reference's ``where(idx == 0, x_t, buf)``, is stage
0's and zero elsewhere, summed over 'stage' so every stage's copy gets
it), and the replicated grads are never summed over 'stage'. Every
grad is summed over 'data'.
"""
import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import train as train_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib

STAGE_AXIS = mesh_lib.STAGE_AXIS
DATA_AXIS = mesh_lib.DATA_AXIS
Params = llama.Params


def make_pp_mesh(stage: int, data: int = 1, ranks=None,
                 rank: Optional[int] = None) -> Optional[mesh_lib.Mesh]:
    """A ``('data', 'stage')`` mesh, stage innermost (consecutive stages
    on consecutive ranks); ``ranks`` and ``rank`` as
    ``mesh.make_mesh``'s."""
    return mesh_lib.build_mesh({DATA_AXIS: data, STAGE_AXIS: stage},
                               ranks, rank)


def pp_param_partition_specs(cfg: llama.LlamaConfig) -> Params:
    """Each layer-stacked leaf's layer dim over 'stage', its other dims
    whole; embedding, head and norms replicated."""
    specs = llama.param_partition_specs(cfg)
    specs['layers'] = {k: (STAGE_AXIS,) + (None,) * (len(v) - 1)
                       for k, v in specs['layers'].items()}
    specs['tok_embedding'] = (None, None)
    specs['lm_head'] = (None, None)
    specs['out_norm'] = (None,)
    return specs


class _GPipe(torch.autograd.Function):
    """The pipeline of one stage: ``run(layers, h)`` is this stage's
    body, ``xs`` [M, mb, S, D] the microbatches (read on stage 0).
    Returns the outputs [M, mb, S, D] on the last stage, zeros on the
    others. Forward keeps each microbatch's graph; backward runs the
    reverse schedule by hand, so every stage sends and receives at the
    same ticks in both directions."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, run, mesh, xs, *layers):
        n, s, m_count = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS), len(xs)
        build = any(ctx.needs_input_grad[2:])
        ws = [w.detach().requires_grad_(build) for w in layers]
        ins: List[Optional[torch.Tensor]] = [None] * m_count
        outs: List[Optional[torch.Tensor]] = [None] * m_count
        ys = torch.zeros_like(xs)
        buf = None
        grad_mode = torch.enable_grad() if build else contextlib.nullcontext()
        for t in range(m_count + n - 1):
            m = t - s
            out = None
            if 0 <= m < m_count:
                inp = (xs[m] if s == 0 else buf).detach().requires_grad_(build)
                with grad_mode:
                    out = run(ws, inp)
                ins[m], outs[m] = inp, out
                if s == n - 1:
                    ys[m] = out.detach()
            if t < m_count + n - 2:
                buf = mesh.ppermute(torch.zeros_like(xs[0]) if out is None
                                    else out.detach(), STAGE_AXIS, 1)
        ctx.mesh, ctx.ws, ctx.ins, ctx.outs = mesh, ws, ins, outs
        return ys

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, dys):
        mesh, ws = ctx.mesh, ctx.ws
        n, s, m_count = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS), len(dys)
        dws = [torch.zeros_like(w, dtype=torch.float32) for w in ws]
        dxs = torch.zeros_like(dys)
        buf = None
        for t in reversed(range(m_count + n - 1)):
            m = t - s
            dinp = None
            if 0 <= m < m_count:
                dout = dys[m] if s == n - 1 else buf
                grads = torch.autograd.grad(ctx.outs[m], [ctx.ins[m]] + ws,
                                            dout)
                dinp = grads[0]
                for acc, g in zip(dws, grads[1:]):
                    acc += g.float()
                ctx.ins[m] = ctx.outs[m] = None
                if s == 0:
                    dxs[m] = dinp
            if t > 0:
                buf = mesh.ppermute(torch.zeros_like(dys[0]) if dinp is None
                                    else dinp, STAGE_AXIS, -1)
        return (None, None, dxs) + tuple(g.to(w.dtype)
                                         for g, w in zip(dws, ws))


def _stage_body(cfg: llama.LlamaConfig, names, cos, sin) -> Callable:
    """This stage's layers in order, each ``llama._block``, under
    ``checkpoint`` when ``cfg.remat`` is set (the reference's
    ``jax.checkpoint`` over the block, no policy)."""
    def run(layers, h):
        for weights in zip(*(w.unbind(0) for w in layers)):
            args = (cfg, h, dict(zip(names, weights)), cos, sin, None, None)
            h = (checkpoint(llama._block, *args, use_reentrant=False)  # pylint: disable=protected-access
                 if cfg.remat and torch.is_grad_enabled()
                 else llama._block(*args))  # pylint: disable=protected-access
        return h
    return run


def pipeline_loss_fn(params: Params, tokens: torch.Tensor,
                     targets: torch.Tensor, cfg: llama.LlamaConfig,
                     mesh: mesh_lib.Mesh,
                     num_microbatches: int) -> torch.Tensor:
    """Pipelined next-token CE: embed → GPipe decoder stages → norm, head
    and CE (in ``cfg.ce_chunks`` chunks). ``tokens``/``targets`` are the
    global [B, S] (the same on every rank), B divisible by
    ``num_microbatches × data``; ``params`` this rank's, under
    :func:`pp_param_partition_specs`. Returns this data rank's share of
    the global mean (the data ranks' shares sum to it)."""
    n = mesh.size(STAGE_AXIS)
    if cfg.n_layers % n:
        raise ValueError(f'{cfg.n_layers} layers do not split over '
                         f'{n} stages')
    b, s = tokens.shape
    data = mesh.size(DATA_AXIS)
    if b % (num_microbatches * data):
        raise ValueError(f'a batch of {b} does not split into '
                         f'{num_microbatches} microbatches over {data} '
                         'data ranks')
    part = b // num_microbatches // data
    rows = slice(mesh.coord(DATA_AXIS) * part,
                 (mesh.coord(DATA_AXIS) + 1) * part)
    tok = tokens.reshape(num_microbatches, -1, s)[:, rows]
    tgt = targets.reshape(num_microbatches, -1, s)[:, rows]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cos, sin = llama._rope_freqs(cfg, positions)  # pylint: disable=protected-access
    xs = params['tok_embedding'][tok.long()].to(cfg.dtype)
    xs = mesh_lib.copy_to(xs, mesh, STAGE_AXIS)
    names = sorted(params['layers'])
    ys = _GPipe.apply(_stage_body(cfg, names, cos, sin), mesh, xs,
                      *(params['layers'][k] for k in names))
    ys = mesh_lib.reduce_from(ys, mesh, STAGE_AXIS)
    y = llama.rms_norm(ys.reshape(-1, s, cfg.dim), params['out_norm'],
                       cfg.norm_eps)
    tgt = tgt.reshape(-1, s)
    if cfg.ce_chunks > 1:
        return llama.chunked_cross_entropy(y, params['lm_head'], tgt,
                                           cfg.ce_chunks, b * s)
    logits = (y @ params['lm_head']).float()
    return llama._xent_from_logits(logits, tgt) / (b * s)  # pylint: disable=protected-access


def value_and_grad(params: Params, tokens: torch.Tensor,
                   targets: torch.Tensor, cfg: llama.LlamaConfig,
                   mesh: mesh_lib.Mesh, num_microbatches: int
                   ) -> Tuple[torch.Tensor, Params]:
    """(the global mean loss, this rank's grads, summed over 'data')."""
    leaves = train_lib.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = pipeline_loss_fn(params, tokens, targets, cfg, mesh,
                                num_microbatches)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [mesh.all_reduce(g, DATA_AXIS) for g in grads]
    loss = mesh.all_reduce(loss.detach(), DATA_AXIS)
    return loss, train_lib._unflatten(params, grads)  # pylint: disable=protected-access


def make_pp_train_step(cfg: llama.LlamaConfig,
                       train_cfg: train_lib.TrainConfig,
                       mesh: mesh_lib.Mesh, num_microbatches: int):
    """``(state, tokens, targets) → (state, metrics)``: the GPipe step
    with ``train.make_optimizer``'s clip and AdamW on this rank's
    params (updated in place); tokens/targets the global batch. Metrics:
    the reference's ``loss``, and ``grad_norm``, the pre-clip norm the
    optimizer computes (as ``train.make_train_step`` reports it)."""
    opt = train_lib.make_optimizer(train_cfg)
    specs = pp_param_partition_specs(cfg)

    def step_fn(state: train_lib.TrainState, tokens, targets
                ) -> Tuple[train_lib.TrainState, Dict[str, torch.Tensor]]:
        device = train_lib.tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        loss, grads = value_and_grad(state.params, tokens, targets, cfg,
                                     mesh, num_microbatches)
        norm = opt.update(grads, state.opt_state, state.params,
                          train_lib.global_norm(grads, mesh, specs))
        state.step += 1
        return state, {'loss': loss, 'grad_norm': norm}

    return step_fn


def init_pp_train_state(cfg: llama.LlamaConfig,
                        train_cfg: train_lib.TrainConfig,
                        mesh: mesh_lib.Mesh,
                        device=None) -> train_lib.TrainState:
    """Params (seed 0, drawn as one rank's ``llama.init_params`` draws
    them, this stage's layers kept) and zero Adam state, split
    stage-wise from birth, on ``device`` (default CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device, mesh,
                               pp_param_partition_specs(cfg))
    return train_lib.TrainState(
        params=params, opt_state=train_lib.make_optimizer(train_cfg).init(
            params), step=0)
