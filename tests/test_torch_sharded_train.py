"""The port's sharded trainer (skypilot_tpu_torch/models/train.py,
llama.py, checkpoint.py on a ``parallel/mesh.Mesh``) against the
reference's sharded train step, ``skypilot_tpu/models/train.py``
``make_train_step(mesh=)``, on the ``debug`` config.

The port runs SPMD on four gloo CPU ranks (this process and three fresh
interpreters of one ``local_ranks`` call, one thread each), the
reference in this process over the conftest's 8 virtual devices (its
first 4), on the same weights (the reference's ``init_params``, bridged
through ``convert.params_from_numpy`` and sliced by each rank) and the
same global batches:

* fp32 at (fsdp 2, model 2), with remat 'full', 2 cross-entropy chunks
  and the flash path (the twins here, the reference's dense fallback),
  and at (dcn 2, fsdp 2), plain: each step's loss and grad norm rel
  2e-5, the params after 3 steps atol 2e-5, the first step's grads
  within 2e-4 of each leaf's largest |value| (the rules of
  tests/test_torch_train.py);
* bf16 at (fsdp 2, model 2): the step-1 loss within rtol 5e-3, the
  reference's own bound for its sharded step
  (tests/unit_tests/test_models.py::test_sharded_train_step_dp_fsdp_tp);
* a rank's init and save make no tensor larger than one layer of a
  stacked leaf, and the same seed draws the same params at any mesh;
* checkpoints in the one-device format: one saved at (fsdp 2, model 2)
  resumes on one rank and one saved on one rank resumes at (fsdp 2,
  model 2), each continuing with the losses of a run never stopped
  (fp32, rel 2e-5);
* fp32 at (fsdp 2, seq 2) and (fsdp 2, expert 2), read as the reference
  reads those axes (the batch split over fsdp only, params and moments
  replicated along seq and expert, no sum over either), under the fp32
  rules above; ``ring_attention=True`` raises in both packages (the
  reference: ``NameError: unbound axis name: seq``);
* a gang of the CLI whose processes disagree or do not fit the mesh
  fails on every process.

The card case (``cuda`` marker) runs on a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_train.py``.
This file imports JAX only inside the fixtures and cases that run the
reference, so the ranks do not.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import checkpoint as tckpt
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
F32_GRAD_TOL = 2e-4
BF16_LOSS_RTOL = 5e-3
STEPS = 3
BATCH, SEQ = 4, 32
# name → (mesh: multislice slices or None, per-slice MeshConfig kwargs,
# dtype, config overrides)
CASES = {
    'fsdp2-model2': (None, dict(fsdp=2, model=2), 'fp32',
                     dict(remat=True, ce_chunks=2, flash_attention=True)),
    'dcn2-fsdp2': (2, dict(fsdp=2), 'fp32', dict()),
    'bf16-fsdp2-model2': (None, dict(fsdp=2, model=2), 'bf16', dict()),
    # 'seq' and 'expert' are replicated compute for the llama trainer.
    'fsdp2-seq2': (None, dict(fsdp=2, seq=2), 'fp32', dict()),
    'fsdp2-expert2': (None, dict(fsdp=2, expert=2), 'fp32', dict()),
}
CKPT_CASE = 'fsdp2-model2'


def _train_cfg():
    return ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)


def _port_cfg(dtype, overrides):
    cfg = dataclasses.replace(tllama.CONFIGS['debug'], **overrides)
    if dtype == 'fp32':
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg


def _port_mesh(slices, kw):
    if slices:
        return tmesh.make_multislice_mesh(slices, tmesh.MeshConfig(**kw))
    return tmesh.make_mesh(tmesh.MeshConfig(**kw))


def _batches():
    return [ttrain.synthetic_batch(256, BATCH, SEQ, 1, step)
            for step in range(STEPS)]


def _np_tree(tree):
    """A gathered tree as numpy (None leaves off rank 0)."""
    return ttrain.tree_map(lambda t: None if t is None else t.float().numpy(),
                           tree)


def _rank_runs(trees, ckpt_dirs):
    """Rank function: every case of CASES from the reference's params
    (``trees[dtype]``, numpy), then the checkpoints. Returns rank 0's
    readings, gathered to whole tensors."""
    out = {}
    for name, (slices, kw, dtype, overrides) in CASES.items():
        cfg = _port_cfg(dtype, overrides)
        mesh = _port_mesh(slices, kw)
        params = ttrain.tree_map(lambda t, c=cfg: t.to(c.dtype),
                                 convert.params_from_numpy(trees[dtype],
                                                           cfg))
        whole = ttrain.TrainState(
            params, ttrain.make_optimizer(_train_cfg()).init(params), 0)
        state = ttrain.shard_state(whole, mesh)
        del whole, params
        tokens, targets = (torch.from_numpy(a) for a in _batches()[0])
        rows = mesh.batch_rows(BATCH)
        _, grads = ttrain.value_and_grad(state.params, tokens[rows],
                                         targets[rows], cfg, mesh)
        step = ttrain.make_train_step(cfg, _train_cfg(), mesh)
        losses, norms = [], []
        for tokens, targets in _batches():
            state, metrics = step(state, tokens, targets)
            losses.append(float(metrics['loss']))
            norms.append(float(metrics['grad_norm']))
        out[name] = dict(
            losses=losses, norms=norms,
            grads=_np_tree(ttrain.gather_tree(grads, mesh)),
            params=_np_tree(ttrain.gather_tree(state.params, mesh)),
            local_wq=tuple(state.params['layers']['wq'].shape))
    # A checkpoint saved here (step 2), and one saved on one rank
    # resumed here (steps 3-4).
    cfg = _port_cfg('fp32', CASES[CKPT_CASE][3])
    mesh = _port_mesh(None, CASES[CKPT_CASE][1])
    ttrain.train_loop(cfg, _train_cfg(), 2, BATCH, SEQ, mesh=mesh,
                      checkpoint_dir=ckpt_dirs['mesh'], save_every=2,
                      log_every=0, device='cpu')
    resumed = {}
    ttrain.train_loop(cfg, _train_cfg(), 4, BATCH, SEQ, mesh=mesh,
                      checkpoint_dir=ckpt_dirs['one'], log_every=0,
                      device='cpu', on_step=lambda i, m: resumed.__setitem__(
                          i, float(m['loss'])))
    out['resumed_on_mesh'] = resumed
    out['one_layer'] = _one_layer_whole(mesh, ckpt_dirs['layers'])
    return out


# Four layers and a small vocab, so a stacked leaf (w1: 4 x 8192) is
# larger than any one layer of it or any leaf that is not stacked.
LAYERS_OVERRIDES = dict(n_layers=4, vocab_size=64)


def _one_layer_whole(mesh, ckpt_dir):
    """Rank function part: a sharded init and save of a LAYERS_OVERRIDES
    state, with the largest tensor any op of the init made and the
    largest tensor the save's gathers returned."""
    from torch.utils import _python_dispatch  # pylint: disable=import-outside-toplevel

    class Largest(_python_dispatch.TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            result = func(*args, **(kwargs or {}))
            for t in (result if isinstance(result, (tuple, list))
                      else (result,)):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return result

    cfg = _port_cfg('fp32', LAYERS_OVERRIDES)
    with Largest() as init:
        state = ttrain.init_train_state(cfg, _train_cfg(), 'cpu', mesh)
    gathered = []
    plain = mesh.gather_to_root

    def gather_to_root(x, spec):
        whole = plain(x, spec)
        gathered.append(0 if whole is None else whole.numel())
        return whole

    mesh.gather_to_root = gather_to_root
    try:
        tckpt.save(ckpt_dir, state, 1, mesh=mesh)
    finally:
        mesh.gather_to_root = plain
    return dict(init_numel=init.numel, save_numel=max(gathered))


def _one_rank_losses(ckpt_dir, steps):
    cfg = _port_cfg('fp32', CASES[CKPT_CASE][3])
    seen = {}
    ttrain.train_loop(cfg, _train_cfg(), steps, BATCH, SEQ,
                      checkpoint_dir=ckpt_dir, save_every=2, log_every=0,
                      device='cpu',
                      on_step=lambda i, m: seen.__setitem__(
                          i, float(m['loss'])))
    return seen


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the port's readings, the reference's readings by case)."""
    import jax  # pylint: disable=import-outside-toplevel
    tmp = tmp_path_factory.mktemp('sharded_ckpt')
    dirs = {'mesh': str(tmp / 'mesh'), 'one': str(tmp / 'one'),
            'layers': str(tmp / 'layers')}
    unbroken = _one_rank_losses(None, 4)
    _one_rank_losses(dirs['one'], 2)
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    trees = {}
    for dtype in ('fp32', 'bf16'):
        jcfg = _reference_cfg(dtype, {})
        trees[dtype] = jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            jllama.init_params(jax.random.PRNGKey(0), jcfg))
    port = distributed.local_ranks(4, _rank_runs, (trees, dirs),
                                   platform='cpu')
    port['unbroken'] = unbroken
    port['resumed_on_one'] = _one_rank_losses(dirs['mesh'], 4)
    port['one_layer']['restored'] = tckpt.restore(dirs['layers'], 1, 'cpu')
    reference = {name: _reference_run(*case)
                 for name, case in CASES.items()}
    return port, reference


def _reference_cfg(dtype, overrides):
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    cfg = dataclasses.replace(jllama.CONFIGS['debug'], **overrides)
    if dtype == 'fp32':
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    return cfg


def _reference_run(slices, kw, dtype, overrides):
    """The reference's sharded step on 4 of the 8 virtual devices."""
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import train as jtrain  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    cfg = _reference_cfg(dtype, overrides)
    devices = jax.devices()[:4]
    mesh = (jmesh.make_multislice_mesh(slices, jmesh.MeshConfig(**kw),
                                       devices=devices) if slices else
            jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=devices))
    tc = jtrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), cfg, tc,
                                    mesh=mesh)
    tokens, targets = _batches()[0]
    grads = jax.jit(jax.grad(jllama.loss_fn), static_argnums=3)(
        state.params, tokens, targets, cfg)
    grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    step = jtrain.make_train_step(cfg, tc, mesh=mesh)
    losses, norms = [], []
    for tokens, targets in _batches():
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics['loss']))
        norms.append(float(metrics['grad_norm']))
    return dict(losses=losses, norms=norms, grads=grads,
                params=jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    state.params))


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f'{k}/{n}', x) for k in sorted(tree)
                for n, x in _leaves(tree[k])]
    return [('', tree)]


def _check_fp32_run(got, want):
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=F32_TOL)
    np.testing.assert_allclose(got['norms'], want['norms'], rtol=F32_TOL)
    for (path, g), (_, w) in zip(_leaves(got['params']),
                                 _leaves(want['params'])):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL,
                                   err_msg=path)
    for (path, g), (_, w) in zip(_leaves(got['grads']),
                                 _leaves(want['grads'])):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_GRAD_TOL * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize('name', ['fsdp2-model2', 'dcn2-fsdp2'])
def test_fp32_steps_match_the_reference_sharded_step(runs, name):
    port, reference = runs
    _check_fp32_run(port[name], reference[name])


def test_bf16_step_1_loss_matches_the_reference(runs):
    port, reference = runs
    got, want = port['bf16-fsdp2-model2'], reference['bf16-fsdp2-model2']
    np.testing.assert_allclose(got['losses'][0], want['losses'][0],
                               rtol=BF16_LOSS_RTOL)
    assert all(np.isfinite(got['losses'] + got['norms']))


def test_each_rank_holds_its_slice(runs):
    """debug: wq [L, 64, 64] at (fsdp 2, model 2) is [L, 32, 32] a rank
    (4 query heads of 16 split 2 ways, the model dim 2 ways)."""
    port, _ = runs
    assert port['fsdp2-model2']['local_wq'] == (2, 32, 32)
    assert port['dcn2-fsdp2']['local_wq'] == (2, 32, 64)


def test_checkpoints_resume_across_meshes(runs):
    port, _ = runs
    want = port['unbroken']
    assert sorted(port['resumed_on_one']) == [3, 4]
    assert sorted(port['resumed_on_mesh']) == [3, 4]
    for got in (port['resumed_on_one'], port['resumed_on_mesh']):
        for step in (3, 4):
            np.testing.assert_allclose(got[step], want[step], rtol=F32_TOL)


def test_init_and_save_hold_one_layer_of_a_stacked_leaf(runs):
    """At (fsdp 2, model 2) no op of a rank's init makes a tensor larger
    than one layer of a stacked leaf or one leaf that is not stacked,
    nor does any gather of the save return one; the params are those
    one rank draws from the same seed."""
    port, _ = runs
    cfg = _port_cfg('fp32', LAYERS_OVERRIDES)
    shapes = tllama.param_shapes(cfg)
    bound = max([int(np.prod(s[1:])) for s in shapes['layers'].values()] +
                [int(np.prod(s)) for n, s in shapes.items()
                 if n != 'layers'])
    assert bound < max(int(np.prod(s)) for s in shapes['layers'].values())
    assert 0 < port['one_layer']['init_numel'] <= bound
    assert 0 < port['one_layer']['save_numel'] <= bound
    want = ttrain.init_train_state(cfg, _train_cfg(), 'cpu')
    for got, whole in zip(
            ttrain.tree_leaves(port['one_layer']['restored'].params),
            ttrain.tree_leaves(want.params)):
        assert torch.equal(got, whole)


def test_restore_slices_a_checkpoint_to_any_rank(tmp_path):
    """A one-device checkpoint restores as any rank's slices, checked
    against that rank's abstract state; another config's raises."""
    root = tmp_path / 'ckpt'
    cfg = _port_cfg('fp32', {})
    state = ttrain.init_train_state(cfg, _train_cfg(), 'cpu')
    tckpt.save(str(root), state, 1)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, model=2),
                           ranks=range(4), rank=3)
    abstract = tckpt.abstract_train_state(cfg, _train_cfg(), mesh)
    restored, step = tckpt.restore_latest(str(root), 'cpu', mesh, abstract)
    assert step == 1
    for got, whole, spec in zip(
            ttrain.tree_leaves(restored.params),
            ttrain.tree_leaves(state.params),
            ttrain.tree_leaves(tllama.param_partition_specs(cfg))):
        assert torch.equal(got, tmesh.shard_tensor(whole, spec, mesh))
    wrong = tckpt.abstract_train_state(
        dataclasses.replace(cfg, ffn_dim=256), _train_cfg(), mesh)
    with pytest.raises(ValueError, match='w1'):
        tckpt.restore_latest(str(root), 'cpu', mesh, wrong)


@pytest.mark.parametrize('case', ['fsdp2-seq2', 'fsdp2-expert2',
                                  'ring_attention'])
def test_seq_or_expert_axis_raises(runs, case):
    """A seq or expert axis no longer raises: the fp32 steps on it match
    the reference's sharded step on the same mesh. What raises, in both
    packages, is ring attention in the trainer, which gives it no
    sequence-sharded context."""
    if case != 'ring_attention':
        port, reference = runs
        _check_fp32_run(port[case], reference[case])
        assert port[case]['local_wq'] == (2, 32, 64)
        return
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import train as jtrain  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    tokens, targets = _batches()[0]
    kw = dict(fsdp=2, seq=2)
    cfg = _port_cfg('fp32', dict(ring_attention=True))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(4))
    with pytest.raises(ValueError, match='unbound axis name: seq'):
        ttrain.make_train_step(cfg, _train_cfg(), mesh)
    with pytest.raises(ValueError, match='unbound axis name: seq'):
        ttrain.train_loop(cfg, _train_cfg(), 1, BATCH, SEQ, log_every=0,
                          device='cpu')
    params = ttrain.init_train_state(_port_cfg('fp32', {}), _train_cfg(),
                                     'cpu').params
    with pytest.raises(ValueError, match='unbound axis name: seq'):
        tllama.loss_fn(params, torch.from_numpy(tokens),
                       torch.from_numpy(targets), cfg)
    jcfg = _reference_cfg('fp32', dict(ring_attention=True))
    jm = jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=jax.devices()[:4])
    tc = jtrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, tc,
                                    mesh=jm)
    with pytest.raises(NameError, match='unbound axis name: seq'):
        jtrain.make_train_step(jcfg, tc, mesh=jm)(state, tokens, targets)


def test_selective_remat_over_fsdp_raises():
    cfg = _port_cfg('fp32', dict(remat=True, remat_policy='dots'))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2), ranks=range(2))
    with pytest.raises(NotImplementedError, match='dots'):
        ttrain.make_train_step(cfg, _train_cfg(), mesh)


def _gang(n, args_of, timeout=120):
    """Run ``n`` processes of the trainer's CLI as a gang (the env
    triple); ``args_of(rank)`` gives each its arguments. Returns
    [(returncode, stdout, stderr)] by process id."""
    env = dict(os.environ, OMP_NUM_THREADS='1', **{
        distributed.COORDINATOR_ENV: f'127.0.0.1:{distributed.free_port()}',
        distributed.NUM_PROCESSES_ENV: str(n)})
    env.pop(distributed.DISABLE_ENV, None)
    env.pop('MEGASCALE_NUM_SLICES', None)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.models.train',
           '--model', 'debug', '--device', 'cpu', '--seq-len', '32',
           '--log-every', '1']
    procs = [subprocess.Popen(cmd + args_of(r), cwd=REPO_ROOT, env=dict(
        env, **{distributed.PROCESS_ID_ENV: str(r)}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize('args_of,error', [
    (lambda r: ['--steps', '2'] + (['--num-slices', '2'] if r == 0 else []),
     'disagree'),
    (lambda r: ['--steps', '2', '--num-slices', '3'],
     'not divisible into 3 slices'),
    (lambda r: ['--steps', '2', '--batch-size', '3'], 'does not split'),
], ids=['disagree', 'slices-misfit', 'batch-misfit'])
def test_mismatched_gang_fails_on_every_process(args_of, error):
    """A gang whose processes disagree, or whose size does not fit the
    mesh or the batch, fails on every process before the first step,
    never hanging in a collective."""
    results = _gang(2, args_of)
    for code, out, err in results:
        assert code != 0, out
        assert '[train] step' not in out
        assert error in err, err[-2000:]


# --------------------------------------------------------------- card


def _card_runs(dtype_name, layers):
    """Rank function on the card: bench-cpu's width cut to ``layers``
    layers, (fsdp 2, model 2) over four ranks on one card (gloo), 2
    steps from seed 0; each rank's flash launches a step."""
    from skypilot_tpu_torch.ops import flash_attention as fa  # pylint: disable=import-outside-toplevel
    cfg = dataclasses.replace(
        tllama.CONFIGS['bench-cpu'], n_layers=layers, remat=True,
        flash_attention=True, ce_chunks=2,
        dtype=torch.float32 if dtype_name == 'fp32' else torch.bfloat16)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, model=2))
    state = ttrain.init_train_state(cfg, _train_cfg(), 'cuda', mesh)
    step = ttrain.make_train_step(cfg, _train_cfg(), mesh)
    fa.reset_launch_counts()
    readings = []
    for i in range(2):
        tokens, targets = ttrain.synthetic_batch(cfg.vocab_size, 4, 128, 1,
                                                 i)
        state, metrics = step(state, tokens, targets)
        readings.append((float(metrics['loss']),
                         float(metrics['grad_norm'])))
    launches = [fn.launches for fn in fa.KERNELS]
    seen = [None] * 4
    torch.distributed.all_gather_object(seen, launches)
    return readings, seen, cfg


@pytest.mark.cuda
@pytest.mark.parametrize('dtype_name', ['bf16', 'fp32'])
def test_four_ranks_on_one_card_match_one_rank(dtype_name):
    """Four ranks sharing the card over gloo (host copies) against one
    rank's step on the same seed: each rank launched the flash forward
    2L times a step and dq, dk/dv L times (remat 'full'); the losses and
    grad norms agree (fp32 rel 2e-5; bf16 step 1 rtol 5e-3)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    readings, launches, cfg = distributed.local_ranks(
        4, _card_runs, (dtype_name, 2), devices=['cuda:0'] * 4,
        backend='gloo')
    layers = cfg.n_layers
    assert launches == [[4 * layers, 2 * layers, 2 * layers]] * 4
    state = ttrain.init_train_state(cfg, _train_cfg(), 'cuda')
    step = ttrain.make_train_step(cfg, _train_cfg())
    for i, (loss, norm) in enumerate(readings):
        tokens, targets = ttrain.synthetic_batch(cfg.vocab_size, 4, 128, 1,
                                                 i)
        state, metrics = step(state, tokens, targets)
        if dtype_name == 'fp32':
            np.testing.assert_allclose(loss, float(metrics['loss']),
                                       rtol=F32_TOL)
            np.testing.assert_allclose(norm, float(metrics['grad_norm']),
                                       rtol=F32_TOL)
        elif i == 0:
            np.testing.assert_allclose(loss, float(metrics['loss']),
                                       rtol=BF16_LOSS_RTOL)
