"""Training: optimizer, train step, MFU accounting, loop, CLI.

Counterpart of ``skypilot_tpu/models/train.py``, on one device or on a
training mesh (``parallel/mesh.py``): one process a rank, every rank
running the same train step on its own slices and rows (SPMD, as a JAX
gang runs it). On a mesh the params and Adam moments are sliced by
``llama.param_partition_specs``, every rank builds the same global
``(seed, step)`` batch and keeps its rows (``Mesh.batch_rows``; the
'model', 'seq' and 'expert' ranks of one batch slice keep the same
rows: the reference's batch spec leaves 'seq' and 'expert' out and no
llama param names them, so they are replicated compute, never summed
over), the loss is the mean over the global batch, each grad is summed
over the ranks that share its slice (``mesh.gather_shards``' backward
for the sharded params; the batch ranks for the replicated norms), the
global-norm clip counts every leaf once, and the AdamW update runs
elementwise on each rank's slices. A ``moe.MoeConfig`` trains the
mixture of experts of ``models/moe.py`` the same way, its experts split
over 'expert'. The optimizer is written as plain functions on tensors
that reproduce optax's arithmetic step for step, for
``chain(clip_by_global_norm(grad_clip), adamw(schedule))``:

* ``clip_by_global_norm``: rescale by ``max_norm / norm`` only when
  ``norm >= max_norm``; the ``grad_norm`` metric is the pre-clip norm;
* ``scale_by_adam`` (or the reference's ``_scale_by_adam_low_mem`` for
  a ``moment_dtype`` other than 'float32'), ``add_decayed_weights``,
  ``scale_by_learning_rate`` with the learning rate rounded to the
  update's dtype, then ``params + updates`` cast to the param dtype;
* ``warmup_cosine_decay_schedule(0, lr, warmup, max(10 * warmup, 1000))``
  read at the count *before* the step, so step 1 runs at lr 0.

Quirk kept from the reference: ``optax.adamw`` on bf16 params stores its
moments in bf16, so ``moment_dtype='float32'`` (the default) means
moments in the param dtype, not fp32.

The step updates params and moments in place (the reference donates its
state to the jitted step) and returns the same state object.
"""
import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import checkpoint as ckpt_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.observability import runtime_metrics
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = llama.Params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # Storage dtype for the Adam moments. 'float32' is optax.adamw, whose
    # moments take the param dtype (bf16 for bf16 params); any other
    # value stores mu and nu in that dtype with the update math in fp32.
    moment_dtype: str = 'float32'


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and both moments."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamState
    step: int


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in ``jax.tree.leaves`` order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """``warmup_cosine_decay_schedule(0, lr, warmup, max(10 * warmup,
    1000))`` at ``count``, in float32 as optax computes it."""
    f32 = np.float32
    warmup = cfg.warmup_steps
    decay_steps = max(10 * warmup, 1000)
    if count < warmup:
        frac = f32(1) - f32(max(count, 0)) / f32(warmup)
        return float(f32(0.0 - cfg.learning_rate) * frac +
                     f32(cfg.learning_rate))
    t = f32(min(count - warmup, decay_steps - warmup))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t /
                                         f32(decay_steps - warmup)))
    return float(f32(cfg.learning_rate) * cosine)


def _moment_dtype(cfg: TrainConfig, param: torch.Tensor) -> torch.dtype:
    if cfg.moment_dtype == 'float32':
        return param.dtype
    return getattr(torch, cfg.moment_dtype)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32."""
    return float(np.float32(1) - np.float32(decay)**np.float32(count))


def global_norm(tree, mesh: Optional[mesh_lib.Mesh] = None,
                specs=None) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the summed squares of every leaf, in
    the leaves' dtype (each leaf's sum taken in fp32). On a ``mesh`` the
    leaves are this rank's slices under ``specs``: a sharded leaf's sum
    of squares is summed in fp32 over the axes its spec names (one
    all-reduce for the leaves that name the same axes), a replicated
    leaf counts once."""
    leaves = tree_leaves(tree)
    dtype = leaves[0].dtype
    sums = [torch.sum(x.float() * x.float()) for x in leaves]
    if mesh is not None:
        by_axes: Dict[frozenset, List[int]] = {}
        for i, spec in enumerate(tree_leaves(specs)):
            axes = frozenset(a for entry in spec if entry is not None
                             for a in ((entry,) if isinstance(entry, str)
                                       else entry))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            reduced = mesh.all_reduce(torch.stack([sums[i] for i in idx]),
                                      tuple(sorted(axes)))
            for j, i in enumerate(idx):
                sums[i] = reduced[j]
    return torch.sqrt(sum(x.to(dtype) for x in sums))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) → AdamState``; ``update(grads, state, params,
    grad_norm=None) → pre-clip grad norm`` applies one step to params
    and moments in place (``grad_norm``: the grads' global norm when the
    caller has it, as a mesh step does)."""
    init: Callable[[Params], AdamState]
    update: Callable[..., torch.Tensor]


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
    low_mem = cfg.moment_dtype != 'float32'

    def init(params: Params) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=_moment_dtype(cfg, p))
        return AdamState(count=0, mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def adam(g, mu, nu, count):
        """One leaf's scaled update; writes the new moments."""
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        if low_mem:
            mu32 = mu.float() * b1 + g.float() * (1 - b1)
            nu32 = nu.float() * b2 + torch.square(g.float()) * (1 - b2)
            mu.copy_(mu32)
            nu.copy_(nu32)
            return (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / torch.tensor(bc1).to(mu.dtype)
        nu_hat = nu / torch.tensor(bc2).to(nu.dtype)
        return mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)

    @torch.no_grad()
    def update(grads: Params, state: AdamState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        norm = global_norm(grads) if grad_norm is None else grad_norm
        clip = not bool(norm < cfg.grad_clip)
        count = state.count + 1
        lr = -learning_rate(cfg, state.count)
        for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                                tree_leaves(state.mu),
                                tree_leaves(state.nu)):
            if clip:
                g = (g / norm.to(g.dtype)) * cfg.grad_clip
            u = adam(g, mu, nu, count)
            u = u + cfg.weight_decay * p
            u = torch.tensor(lr).to(u.dtype) * u
            p.copy_(p + u)
        state.count = count
        return norm

    return Optimizer(init=init, update=update)


def model_of(model_cfg: llama.LlamaConfig):
    """The model module a config trains: ``models/moe.py`` for a
    ``moe.MoeConfig``, else ``models/llama.py``."""
    return moe if isinstance(model_cfg, moe.MoeConfig) else llama


def _check_mesh(model_cfg: llama.LlamaConfig,
                mesh: Optional[mesh_lib.Mesh]) -> None:
    if model_of(model_cfg) is moe:
        moe.check_mesh(model_cfg, mesh)
        return
    llama.check_no_ring(model_cfg)
    if mesh is None:
        return
    llama.check_remat(model_cfg, mesh)
    tp = mesh.size(mesh_lib.MODEL_AXIS)
    if model_cfg.n_kv_heads % tp:
        raise ValueError(f'{model_cfg.n_kv_heads} KV heads do not split '
                         f'over a model axis of {tp}')


def init_train_state(model_cfg: llama.LlamaConfig, train_cfg: TrainConfig,
                     device=None,
                     mesh: Optional[mesh_lib.Mesh] = None) -> TrainState:
    """Random params (seed 0, as the reference's PRNGKey(0); the draws
    differ from ``jax.random``'s) and zero Adam state on ``device``
    (default CUDA; without a card only ``device='cpu'`` runs). With a
    ``mesh``, this rank's slices of the same params, drawn leaf by leaf
    (no rank holds the whole tree); the moments mirror the slices and
    the count replicates."""
    device = resolve_device(device)
    _check_mesh(model_cfg, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model_of(model_cfg).init_params(model_cfg, gen, device,
                                             mesh=mesh)
    return TrainState(params=params,
                      opt_state=make_optimizer(train_cfg).init(params),
                      step=0)


def shard_state(state: TrainState, mesh: Optional[mesh_lib.Mesh],
                device=None) -> TrainState:
    """This rank's slices of a whole ``state`` (params and moments under
    ``llama.param_partition_specs``; all of it without a ``mesh``), as
    new tensors on ``device`` (default the state's)."""
    specs = llama.param_partition_specs(None)

    def shard(tree):
        if mesh is None:
            return tree_map(lambda t: t.to(device or t.device, copy=True),
                            tree)
        return mesh_lib.shard_params(tree, mesh, specs, device)

    opt = state.opt_state
    return TrainState(params=shard(state.params),
                      opt_state=AdamState(count=opt.count, mu=shard(opt.mu),
                                          nu=shard(opt.nu)),
                      step=state.step)


def gather_tree(tree, mesh: mesh_lib.Mesh, specs=None):
    """The whole tensors of a sharded params-shaped tree on rank 0's
    host (None leaves elsewhere; every rank calls it). A layer-stacked
    leaf is gathered a layer at a time, each layer copied to the host
    before the next, so no card holds more than one layer of it whole."""
    specs = specs or llama.param_partition_specs(None)
    if isinstance(tree, dict):
        return {k: gather_tree(tree[k], mesh, specs[k]) for k in tree}
    if len(specs) == 1 or specs[0] is not None:
        whole = mesh.gather_to_root(tree, specs)
        return None if whole is None else whole.cpu()
    out = None
    for i, layer in enumerate(tree.unbind(0)):
        whole = mesh.gather_to_root(layer, specs[1:])
        if whole is None:
            continue
        if out is None:
            out = whole.new_empty((len(tree),) + tuple(whole.shape),
                                  device='cpu')
        out[i] = whole
        del whole
    return out


def value_and_grad(params: Params, tokens: torch.Tensor,
                   targets: torch.Tensor, model_cfg: llama.LlamaConfig,
                   mesh: Optional[mesh_lib.Mesh] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """(mean loss, grads) of the model's ``loss_fn`` (llama's, or the
    MoE's for a ``moe.MoeConfig``). On a ``mesh``:
    ``tokens``/``targets`` are this rank's rows, the loss is the global
    batch's mean, and each grad is the whole batch's grad of this rank's
    slice."""
    model = model_of(model_cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(params, tokens, targets, model_cfg, mesh=mesh)
        flat = list(torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    loss = loss.detach()
    if mesh is not None:
        # The sharded leaves' grads were summed in their gathers'
        # backward; the replicated ones sum over the batch ranks here.
        specs = tree_leaves(model.param_partition_specs(model_cfg))
        flat = [g if any(a is not None for a in spec) else
                mesh.all_reduce(g, mesh_lib.BATCH_AXES)
                for g, spec in zip(flat, specs)]
        loss = mesh.all_reduce(loss, mesh_lib.BATCH_AXES)
    return loss, _unflatten(params, flat)


def make_train_step(model_cfg: llama.LlamaConfig, train_cfg: TrainConfig,
                    mesh: Optional[mesh_lib.Mesh] = None):
    """Returns ``(state, tokens, targets) → (state, metrics)`` with
    metrics ``loss`` and ``grad_norm`` (0-dim tensors). With a ``mesh``,
    ``state`` holds this rank's slices and ``tokens``/``targets`` are
    the global batch, split over ``batch_spec``."""
    opt = make_optimizer(train_cfg)
    _check_mesh(model_cfg, mesh)
    specs = model_of(model_cfg).param_partition_specs(model_cfg)

    def step_fn(state: TrainState, tokens, targets
                ) -> Tuple[TrainState, Dict[str, Any]]:
        device = tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        if mesh is not None:
            rows = mesh.batch_rows(tokens.shape[0])
            tokens, targets = tokens[rows], targets[rows]
        loss, grads = value_and_grad(state.params, tokens, targets,
                                     model_cfg, mesh)
        norm = (None if mesh is None else
                global_norm(grads, mesh, specs))
        grad_norm = opt.update(grads, state.opt_state, state.params, norm)
        state.step += 1
        return state, {'loss': loss, 'grad_norm': grad_norm}

    return step_fn


def _unflatten(like, leaves: List[torch.Tensor]):
    """Inverse of ``tree_leaves`` onto the structure of ``like``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return leaves.pop(0)


def tokens_per_second_to_mfu(tokens_per_sec: float,
                             model_cfg: llama.LlamaConfig, seq_len: int,
                             peak_flops: float) -> float:
    """Model FLOPs utilization given hardware peak (bf16) FLOPs/sec."""
    return tokens_per_sec * model_cfg.flops_per_token(seq_len) / peak_flops


def synthetic_batch(vocab_size: int, batch_size: int, seq_len: int,
                    data_seed: int, step: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's deterministic synthetic stream: uniform tokens
    from ``SeedSequence([data_seed, step])``, targets rolled by one."""
    rng = np.random.default_rng(np.random.SeedSequence([data_seed, step]))
    tokens = rng.integers(0, vocab_size, (batch_size, seq_len),
                          dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def train_loop(model_cfg: llama.LlamaConfig,
               train_cfg: TrainConfig,
               num_steps: int,
               batch_size: int,
               seq_len: int,
               mesh: Optional[mesh_lib.Mesh] = None,
               checkpoint_dir: Optional[str] = None,
               save_every: int = 100,
               keep: int = 3,
               data_seed: int = 0,
               log_every: int = 10,
               sleep_per_step: float = 0.0,
               dataset: Optional[Any] = None,
               device=None,
               on_step: Optional[Callable[[int, Dict[str, Any]],
                                          None]] = None) -> TrainState:
    """Run (or RESUME) a training run with periodic checkpointing.

    If ``checkpoint_dir`` holds a complete checkpoint, params, Adam
    moments and step restore from it and the loop continues at step N.
    Batches are a pure function of ``(data_seed, step)``, so a resumed
    run sees the stream it would have seen unpreempted. Each step is
    published through ``observability/runtime_metrics.TrainTelemetry``
    (step seconds, tokens/s and MFU of the global batch, steps),
    ``SKYTPU_PROFILE_DIR`` arms a ``StepProfiler`` capture, and
    ``on_step(step, metrics)`` is called after every step.

    With a ``mesh`` every rank runs the loop on its slices (a checkpoint
    of any mesh resumes on any other); rank 0 alone prints the
    ``[train]`` lines and writes the checkpoints."""
    dev = resolve_device(device)
    _check_mesh(model_cfg, mesh)
    if mesh is not None:
        mesh.batch_rows(batch_size)  # a batch that does not split raises
    lead = mesh is None or mesh.rank == 0

    def log(msg):
        if lead:
            print(f'[train] {msg}', flush=True)

    start_step = 0
    state = None
    if checkpoint_dir:
        restored = ckpt_lib.restore_latest(
            checkpoint_dir, device=dev, mesh=mesh,
            abstract=ckpt_lib.abstract_train_state(model_cfg, train_cfg,
                                                   mesh))
        if restored is not None:
            state, start_step = restored
            log(f'resumed from step {start_step} ({checkpoint_dir})')
    if state is None:
        state = init_train_state(model_cfg, train_cfg, dev, mesh)
    step_fn = make_train_step(model_cfg, train_cfg, mesh)
    # No explicit step_start(): the first record_step silently arms the
    # timer, so the first step (kernel builds, allocator warm-up) never
    # enters the step-time histogram.
    telemetry = runtime_metrics.TrainTelemetry(model_cfg=model_cfg,
                                               seq_len=seq_len, device=dev)
    profiler = runtime_metrics.StepProfiler(tag='train')
    for step in range(start_step, num_steps):
        profiler.step()
        if dataset is not None:
            tokens, targets = dataset.batch(step, batch_size, seq_len,
                                            seed=data_seed)
        else:
            tokens, targets = synthetic_batch(model_cfg.vocab_size,
                                              batch_size, seq_len,
                                              data_seed, step)
        state, metrics = step_fn(state, tokens, targets)
        telemetry.record_step(tokens=batch_size * seq_len)
        if on_step is not None:
            on_step(step + 1, metrics)
        if sleep_per_step:
            time.sleep(sleep_per_step)
        if log_every and (step + 1) % log_every == 0:
            log(f'step {step + 1}/{num_steps} '
                f'loss={float(metrics["loss"]):.4f}')
        if checkpoint_dir and (step + 1) % save_every == 0:
            ckpt_lib.save(checkpoint_dir, state, step + 1, keep=keep,
                          mesh=mesh)
            log(f'checkpoint @ step {step + 1}')
    profiler.stop()
    if (checkpoint_dir and num_steps > start_step and
            num_steps % save_every != 0):  # loop already saved otherwise
        ckpt_lib.save(checkpoint_dir, state, num_steps, keep=keep,
                      mesh=mesh)
        log(f'final checkpoint @ step {num_steps}')
    return state


def main(argv: Optional[List[str]] = None) -> None:
    """CLI for recipes: ``python -m skypilot_tpu_torch.models.train``.

    Under a gang (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` > 1,
    ``JAX_PROCESS_ID``; ``parallel/distributed.py``) every process runs
    this entry point as one rank, on ``cuda:(rank % cards)`` over NCCL
    (gloo with ``--device cpu``), and the ranks form the mesh:
    ``--num-slices`` > 1 (default ``MEGASCALE_NUM_SLICES``) a multislice
    mesh, else fsdp over every rank; one process trains alone. Every
    process must be given the same settings; a gang that disagrees, or
    whose size does not fit the mesh or the batch, fails on every
    process before the first step. Rank 0 alone prints the ``[train]``
    lines and writes the checkpoints."""
    parser = argparse.ArgumentParser(
        description='skypilot_tpu_torch train loop')
    parser.add_argument('--model', default='debug',
                        choices=sorted(llama.CONFIGS))
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=2)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--save-every', type=int, default=10)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--sleep-per-step', type=float, default=0.0)
    parser.add_argument('--num-slices', type=int,
                        default=int(os.environ.get('MEGASCALE_NUM_SLICES',
                                                   '1')))
    parser.add_argument('--data', default=None,
                        help='token file (models/data.py format); '
                        'default: deterministic synthetic stream')
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda; a machine '
                        'without a card needs --device cpu)')
    args = parser.parse_args(argv)
    device = distributed.join_gang(resolve_device(args.device))
    distributed.check_agree({k: v for k, v in vars(args).items()
                             if k != 'device'})
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if args.num_slices > 1:
        mesh = mesh_lib.make_multislice_mesh(args.num_slices)
    elif world > 1:
        mesh = mesh_lib.make_mesh()  # fsdp over every rank by default
    else:
        mesh = None
    cfg = llama.CONFIGS[args.model]
    dataset = None
    if args.data:
        from skypilot_tpu_torch.models import data as data_lib
        dataset = data_lib.TokenDataset.open(args.data)
        if dataset.vocab_size > cfg.vocab_size:
            raise SystemExit(
                f'Dataset vocab {dataset.vocab_size} exceeds model '
                f'vocab {cfg.vocab_size}.')
    state = train_loop(cfg, TrainConfig(warmup_steps=5), args.steps,
                       args.batch_size, args.seq_len, mesh=mesh,
                       checkpoint_dir=args.checkpoint_dir,
                       save_every=args.save_every,
                       log_every=args.log_every,
                       sleep_per_step=args.sleep_per_step,
                       dataset=dataset, device=device)
    if mesh is None or mesh.rank == 0:
        print(f'[train] done at step {state.step}', flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
