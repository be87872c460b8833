"""Training cells: the port's train step (``models/train.make_train_step``
on a ``models/moe.MoeConfig``) on batches drawn from the seed.

Set-up builds the one training state (weights from the seed, the
optimizer's zero moments) and drives it through the step's first
``CHECK_STEPS`` steps, reading what the check compares: each step's
loss, the first gradient by leaf as the optimizer holds it (its first
moment after one step, over ``1 - beta1``), and each leaf's change
after the last of them. The same state goes on into the window, whose
steps are timed. Then, with the program's state freed, the plain
reference takes the same weights and batches through the same steps
(:func:`reference_readings`), and :func:`compare` sets the numbers
beside their limits.
"""
import dataclasses
import gc
import math
import statistics
import sys
import time
from typing import Any, Dict, Optional

from portbench import harness, peaks, reference, weights
from portbench.generators import uniform_batches

CHECK_STEPS = 3
# Window steps run before a traced run profiles, and steps profiled.
TRACE_AFTER, TRACE_STEPS = 2, 2
# A leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone, so its change is not compared.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class TrainContext:
    """What the metric readers of a training cell read."""
    dims: weights.Dims
    traffic: Dict[str, Any]
    deployment: Dict[str, Any]
    setup_s: float
    steps: int = 0
    elapsed_s: float = 0.0
    unprofiled_steps: int = 0
    unprofiled_s: float = 0.0
    trace: Optional[harness.Trace] = None
    traced_steps: int = 0
    peak_bytes: int = 0

    @property
    def tokens_per_step(self) -> int:
        return uniform_batches.tokens_per_step(self.traffic)

    def active_params(self) -> int:
        d = self.dims
        return (d.n_layers * peaks.moe_block_active_params(
            d.dim, d.n_heads, d.n_kv_heads, d.head_dim, d.ffn_dim,
            d.n_experts, d.top_k) + d.dim * d.vocab)


def moe_config(d: weights.Dims, dep: Dict[str, Any]):
    import torch
    from skypilot_tpu_torch.models import moe
    return moe.MoeConfig(
        vocab_size=d.vocab, dim=d.dim, n_layers=d.n_layers,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, ffn_dim=d.ffn_dim,
        rope_theta=d.rope_theta, norm_eps=d.norm_eps, dtype=torch.bfloat16,
        remat=True, remat_policy=dep['remat_policy'],
        flash_attention=dep['flash_attention'], ce_chunks=dep['ce_chunks'],
        n_experts=d.n_experts, top_k=d.top_k,
        capacity_factor=d.capacity_factor,
        router_aux_coef=d.router_aux_coef)


def leaf_index(d: weights.Dims) -> Dict[str, tuple]:
    return {path: (i, shape, dt) for i, (path, shape, dt) in
            enumerate(weights.leaf_specs(d))}


def change_norms(params: Dict, d: weights.Dims, seed: int) -> Dict:
    """Each leaf's norm of (now − as drawn from the seed), the drawn
    leaf made again one at a time."""
    import torch
    out = {}
    for path, (i, shape, dt) in leaf_index(d).items():
        leaf = weights.get_leaf(params, path)
        start = weights.draw_leaf(path, shape, dt, d.init_std, seed, i,
                                  leaf.device)
        out[path] = float(torch.linalg.vector_norm(
            leaf.detach().float() - start.float()))
        del start
    return out


def program_readings(step_fn, state, feed, d: weights.Dims, seed: int,
                     beta1: float):
    """Drive the program's step through its first CHECK_STEPS steps."""
    import torch
    losses, grad1, g1 = [], None, None
    paths = list(leaf_index(d))
    for i in range(CHECK_STEPS):
        state, metrics = step_fn(state, *feed(i))
        losses.append(float(metrics['loss']))
        if i == 0:
            # The first moment after one step is (1 - beta1) times the
            # gradient as the optimizer got it (clipped).
            mu = state.opt_state.mu
            grad1 = {p: float(torch.linalg.vector_norm(
                weights.get_leaf(mu, p).float())) / (1 - beta1)
                for p in paths}
            # Kept in host memory until the reference has run.
            g1 = {p: weights.get_leaf(mu, p).detach().to('cpu', copy=True)
                  for p in paths}
    return state, {'losses': losses, 'grad1': grad1, 'g1': g1,
                   'g1_scale': 1 / (1 - beta1),
                   'change': change_norms(state.params, d, seed)}


def reference_readings(d: weights.Dims, seed: int, traffic, opt: Dict,
                       device, mm=reference.fp32_mm,
                       fault: Optional[str] = None, routing=None,
                       seen=None, steps: int = CHECK_STEPS) -> Dict:
    """The plain reference through the same ``steps`` steps from the
    same weights and batches. ``fault`` plants one in the reference put
    in the program's place: ``'half_batch'`` (the loss a mean over the
    first half of the rows) or ``'unchanged'`` (no update). ``routing``
    and ``seen`` are ``reference.moe_loss``'s, for the first step alone
    (a diagnosis's: ``portbench/control.py --routing``)."""
    import torch
    params = weights.make_params(d, seed, device)
    paths = [p for p, _ in reference.leaves(params)]
    state = {'count': 0,
             'mu': {p: torch.zeros_like(weights.get_leaf(params, p))
                    for p in paths},
             'nu': {p: torch.zeros_like(weights.get_leaf(params, p))
                    for p in paths}}
    losses, grad1, g1 = [], None, None
    with reference.exact_fp32():
        for i in range(steps):
            tokens, targets = uniform_batches.batch(traffic, seed, i,
                                                    d.vocab, device)
            if fault == 'half_batch':
                half = tokens.shape[0] // 2
                tokens, targets = tokens[:half], targets[:half]
            tree32: Dict = {}
            for p in paths:
                weights.set_leaf(tree32, p, weights.get_leaf(
                    params, p).float().requires_grad_(True))
            flat = [weights.get_leaf(tree32, p) for p in paths]
            loss = reference.moe_loss(
                tree32, tokens, targets, d, mm,
                routing if i == 0 else None, seen if i == 0 else None)
            grads = torch.autograd.grad(loss, flat)
            del tree32, flat
            losses.append(float(loss.detach()))
            gtree: Dict = {}
            for p, g in zip(paths, grads):
                weights.set_leaf(gtree, p, g)
            del grads
            with torch.no_grad():
                if fault == 'unchanged':
                    norm = math.sqrt(sum(float((g * g).sum()) for _, g in
                                         reference.leaves(gtree)))
                else:
                    norm = reference.adamw_step(params, gtree, state, opt)
            if i == 0:
                scale = min(1.0, opt['grad_clip'] / norm)
                grad1 = {p: float(torch.linalg.vector_norm(g)) * scale
                         for p, g in reference.leaves(gtree)}
                g1 = {p: (g * scale).to('cpu')
                      for p, g in reference.leaves(gtree)}
            del gtree
    out = {'losses': losses, 'grad1': grad1, 'g1': g1, 'g1_scale': 1.0,
           'change': change_norms(params, d, seed)}
    del params, state
    return out


def _leaf_gap(got: Dict, want: Dict, paths) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    floor = statistics.median(want[p] for p in paths)
    return max(abs(got[p] - want[p]) / max(want[p], floor, 1e-30)
               for p in paths)


def _diff_gap(got: Dict, got_scale: float, want: Dict, want_scale: float,
              norms: Dict, paths, device) -> tuple:
    """The worst leaf's norm of (got − want), against the reference's
    norm (``norms``) of that leaf or of the median leaf, whichever is
    larger, and that leaf's path; one leaf at a time on ``device``."""
    import torch
    floor = statistics.median(norms[p] for p in paths)
    worst, leaf = 0.0, None
    for p in paths:
        diff = (got[p].to(device).float() * got_scale -
                want[p].to(device).float() * want_scale)
        gap = float(torch.linalg.vector_norm(diff)) / max(norms[p], floor,
                                                          1e-30)
        if leaf is None or gap > worst:
            worst, leaf = gap, p
        del diff
    return worst, leaf


def compare(got: Dict, want: Dict, device='cpu') -> Dict[str, Any]:
    """The readings: ``loss_rel`` (the largest relative gap of a step's
    loss), ``grad_norm_gap`` and ``param_change_gap`` (the worst leaf's
    gap between two norms, :func:`_leaf_gap`; the change over the leaves
    the reference moves by more than round-off) and ``grad_diff`` (the
    worst leaf's norm of the first gradients' difference,
    :func:`_diff_gap`), with ``grad_diff_leaf`` the leaf that sets it.
    The workload file's ``limits`` name the ones a run is held to."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got['losses'], want['losses']))
    paths = sorted(want['grad1'])
    g_floor = statistics.median(want['grad1'][p] for p in paths)
    moving = [p for p in paths if want['grad1'][p] >= STILL_LEAF * g_floor]
    grad_diff, leaf = _diff_gap(got['g1'], got['g1_scale'], want['g1'],
                                want['g1_scale'], want['grad1'], paths,
                                device)
    return {'loss_rel': loss_rel,
            'grad_norm_gap': _leaf_gap(got['grad1'], want['grad1'], paths),
            'param_change_gap': _leaf_gap(got['change'], want['change'],
                                          moving),
            'grad_diff': grad_diff, 'grad_diff_leaf': leaf}


def build(cell: harness.Cell, seed: int, device):
    """The program's train step and its state, from the seed."""
    from skypilot_tpu_torch.models import train
    d = weights.dims_of(cell.config)
    dep = cell.config['deployment']
    cfg = moe_config(d, dep)
    tcfg = train.TrainConfig(**dep['optimizer'])
    params = weights.make_params(d, seed, device)
    opt = train.make_optimizer(tcfg)
    state = train.TrainState(params=params, opt_state=opt.init(params),
                             step=0)
    return d, dep, tcfg, train.make_train_step(cfg, tcfg), state


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> harness.Outcome:
    import torch
    harness.stage('imports', t_start)
    d, dep, tcfg, step_fn, state = build(cell, seed, device)
    harness.stage('weights and optimizer state', t_start)
    cuda = torch.cuda.is_available() and device != 'cpu'

    def feed(i):
        return uniform_batches.batch(cell.traffic, seed, i, d.vocab, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    state, got = program_readings(step_fn, state, feed, d, seed, tcfg.beta1)
    ctx = TrainContext(dims=d, traffic=cell.traffic,
                       deployment=dep, setup_s=0.0)
    sync()
    ctx.setup_s = time.monotonic() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = []
    prof = None
    step = CHECK_STEPS
    t0 = last = time.monotonic()
    while True:
        if trace and ctx.steps == TRACE_AFTER:
            sync()
            prof = harness.profiler(torch)
            prof.start()
            with torch.profiler.record_function(harness.WINDOW_MARK):
                for _ in range(TRACE_STEPS):
                    state, metrics = step_fn(state, *feed(step))
                    losses.append(metrics['loss'])
                    step += 1
                sync()
            prof.stop()
            ctx.steps += TRACE_STEPS
            ctx.traced_steps = TRACE_STEPS
            last = time.monotonic()
        else:
            state, metrics = step_fn(state, *feed(step))
            losses.append(metrics['loss'])
            step += 1
            ctx.steps += 1
            now = time.monotonic()
            ctx.unprofiled_s += now - last
            last = now
        if time.monotonic() - t0 >= seconds and (not trace or prof):
            break
    sync()
    now = time.monotonic()
    ctx.unprofiled_s += now - last
    ctx.elapsed_s = now - t0
    ctx.unprofiled_steps = ctx.steps - ctx.traced_steps
    ctx.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    n_failed = sum(not math.isfinite(float(x)) for x in losses)
    del state, step_fn, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if prof is not None:
        ctx.trace = harness.export_and_reduce(
            prof, harness.CACHE_DIR / 'train_trace.json')
        del prof
    want = reference_readings(d, seed, cell.traffic, dep['optimizer'],
                              device)
    numbers = compare(got, want, device)
    print(f'program losses {got["losses"]} reference {want["losses"]}; '
          f'grad_diff set by {numbers["grad_diff_leaf"]}', file=sys.stderr)
    limits = cell.spec['limits']
    checks = {name: (numbers[name], limits[name]) for name in limits}
    return harness.Outcome(checks=checks, attempted=ctx.steps,
                           failed=n_failed,
                           device=harness.device_info(torch, ctx),
                           context=ctx)
