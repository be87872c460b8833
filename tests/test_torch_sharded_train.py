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
* the selective remat policies 'dots', 'ffn' and 'ffn1' at (fsdp 2,
  model 2), fp32, under the fp32 rules above against the reference's
  sharded step under the same policy, and bit-equal to the port's own
  'full' on the same mesh (losses, grad norms, grads and params);
* a rank's init makes no tensor larger than one layer of a stacked
  leaf, its save no tensor larger than its own slices and no gather,
  and the same seed draws the same params at any mesh;
* checkpoints: one saved at (fsdp 2, model 2) resumes on one rank and
  one saved on one rank resumes at (fsdp 2, model 2), each continuing
  with the losses of a run never stopped (fp32, rel 2e-5); states saved
  at (fsdp 2, model 2), (fsdp 4) and (data 2, fsdp 2) restore bit-equal
  on one device and as every rank's slices of each of those meshes;
  each rank's file holds exactly the slices the index gives it, a
  replicated slice written once; an MoE state saves and restores on an
  (expert 2) mesh; a step directory in the earlier one-file format
  still restores;
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
import json
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
# The selective policies over fsdp, each the 'fsdp2-model2' case but
# for its policy.
POLICIES = ('dots', 'ffn', 'ffn1')
for _policy in POLICIES:
    CASES[f'fsdp2-model2-{_policy}'] = (
        None, dict(fsdp=2, model=2), 'fp32',
        dict(CASES['fsdp2-model2'][3], remat_policy=_policy))
CKPT_CASE = 'fsdp2-model2'
# Sharded saves (name → MeshConfig kwargs and the ranks that hold the
# mesh), each restored on one device and as every rank of SAVE_MESHES.
SAVE_MESHES = {'fsdp2-model2': (dict(fsdp=2, model=2), 4),
               'fsdp4': (dict(fsdp=4), 4),
               'data2-fsdp2': (dict(data=2, fsdp=2), 4)}
MOE_SAVE_MESH = (dict(fsdp=1, expert=2), 2)
SAVE_STEP, SAVE_COUNT = 5, 3


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
    for name, (kw, n) in SAVE_MESHES.items():
        mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(n))
        tckpt.save(os.path.join(ckpt_dirs['saves'], name),
                   _save_state(_port_cfg('fp32', {}), mesh), SAVE_STEP,
                   mesh=mesh)
    kw, n = MOE_SAVE_MESH
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(n))
    if mesh is not None:
        tckpt.save(os.path.join(ckpt_dirs['saves'], 'moe'),
                   _save_state(_moe_cfg(), mesh), SAVE_STEP, mesh=mesh)
    return out


def _moe_cfg():
    from skypilot_tpu_torch.models import moe as tmoe  # pylint: disable=import-outside-toplevel
    return dataclasses.replace(tmoe.CONFIGS['moe-debug'],
                               dtype=torch.float32)


def _save_state(cfg, mesh=None):
    """The seed-0 state (on ``mesh``, this rank's slices) with moments
    made from the params elementwise (so a rank's slices of them are
    the whole moments' slices) and a count and step of its own."""
    state = ttrain.init_train_state(cfg, _train_cfg(), 'cpu', mesh)
    opt = state.opt_state
    opt.mu = ttrain.tree_map(lambda p: p * 0.5 - 1, state.params)
    opt.nu = ttrain.tree_map(lambda p: p * p + 2, state.params)
    opt.count, state.step = SAVE_COUNT, SAVE_STEP
    return state


# Four layers and a small vocab, so a stacked leaf (w1: 4 x 8192) is
# larger than any one layer of it or any leaf that is not stacked.
LAYERS_OVERRIDES = dict(n_layers=4, vocab_size=64)


def _one_layer_whole(mesh, ckpt_dir):
    """Rank function part: a sharded init and save of a LAYERS_OVERRIDES
    state, with the largest tensor any op of the init made, the largest
    any op of the save made, the rank's largest slice, and the gathers
    the save made."""
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
        gathered.append(x.numel())
        return plain(x, spec)

    mesh.gather_to_root = gather_to_root
    try:
        with Largest() as save:
            tckpt.save(ckpt_dir, state, 1, mesh=mesh)
    finally:
        mesh.gather_to_root = plain
    own = max(t.numel() for tree in (state.params, state.opt_state.mu,
                                     state.opt_state.nu)
              for t in ttrain.tree_leaves(tree))
    seen = [None] * mesh.num_ranks
    torch.distributed.all_gather_object(
        seen, dict(save_numel=save.numel, own_numel=own, gathers=gathered))
    return dict(init_numel=init.numel, save=seen)


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
            'layers': str(tmp / 'layers'), 'saves': str(tmp / 'saves')}
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
    port['saves'] = dirs['saves']
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
    than one layer of a stacked leaf or one leaf that is not stacked;
    during the save no rank makes a tensor larger than its own largest
    slice, and no rank gathers; the params are those one rank draws from
    the same seed."""
    port, _ = runs
    cfg = _port_cfg('fp32', LAYERS_OVERRIDES)
    shapes = tllama.param_shapes(cfg)
    bound = max([int(np.prod(s[1:])) for s in shapes['layers'].values()] +
                [int(np.prod(s)) for n, s in shapes.items()
                 if n != 'layers'])
    assert bound < max(int(np.prod(s)) for s in shapes['layers'].values())
    assert 0 < port['one_layer']['init_numel'] <= bound
    assert len(port['one_layer']['save']) == 4
    for rank in port['one_layer']['save']:
        assert 0 < rank['save_numel'] <= rank['own_numel'] <= bound
        assert rank['gathers'] == []
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


def test_selective_remat_over_fsdp_raises(runs):
    """'dots', 'ffn' and 'ffn1' no longer raise over fsdp: at (fsdp 2,
    model 2) each policy's fp32 steps match the reference's sharded step
    under the same policy, and equal the port's 'full' on the same mesh
    bit for bit."""
    port, reference = runs
    full = port['fsdp2-model2']
    for policy in POLICIES:
        name = f'fsdp2-model2-{policy}'
        got = port[name]
        _check_fp32_run(got, reference[name])
        assert got['losses'] == full['losses'], policy
        assert got['norms'] == full['norms'], policy
        for key in ('grads', 'params'):
            for (path, g), (_, w) in zip(_leaves(got[key]),
                                         _leaves(full[key])):
                np.testing.assert_array_equal(g, w,
                                              err_msg=f'{policy} {path}')


def _state_leaves(state):
    return [(name, path, leaf)
            for name, tree in (('params', state.params),
                               ('mu', state.opt_state.mu),
                               ('nu', state.opt_state.nu))
            for path, leaf in _leaves(tree)]


def _check_restores(root, cfg, specs, meshes):
    """The checkpoint at ``root`` restored on one device equals the
    whole state, and as every rank of each mesh of ``meshes`` (name →
    (MeshConfig kwargs, ranks)) that rank's slices of it, checked
    against its abstract state."""
    whole = _save_state(cfg)
    one, step = tckpt.restore_latest(root, 'cpu')
    assert step == SAVE_STEP and one.step == SAVE_STEP
    assert one.opt_state.count == SAVE_COUNT
    for (_, path, got), (_, _, want) in zip(_state_leaves(one),
                                            _state_leaves(whole)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    spec_of = dict(_leaves(specs))
    for kw, n in meshes.values():
        for rank in range(n):
            mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(n),
                                   rank=rank)
            restored = tckpt.restore(
                root, SAVE_STEP, 'cpu', mesh,
                tckpt.abstract_train_state(cfg, _train_cfg(), mesh))
            for (_, path, got), (_, _, want) in zip(
                    _state_leaves(restored), _state_leaves(whole)):
                assert torch.equal(got, tmesh.shard_tensor(
                    want, spec_of[path], mesh)), (kw, rank, path)


@pytest.mark.parametrize('saved_on', sorted(SAVE_MESHES))
def test_sharded_save_restores_on_any_mesh(runs, saved_on):
    """A state saved on each mesh restores bit-equal on one device and
    as every rank's slices of every mesh of SAVE_MESHES."""
    port, _ = runs
    cfg = _port_cfg('fp32', {})
    _check_restores(os.path.join(port['saves'], saved_on), cfg,
                    tllama.param_partition_specs(cfg), SAVE_MESHES)


@pytest.mark.parametrize('saved_on', sorted(SAVE_MESHES))
def test_sharded_save_writes_each_slice_once(runs, saved_on):
    """Each rank's file holds exactly the slices the index lists under
    it, at the rank's own offsets and shapes on that mesh; every leaf's
    pieces tile it once (a replicated slice is written by one rank), and
    rank 0 wrote no other rank's slice."""
    port, _ = runs
    kw, n = SAVE_MESHES[saved_on]
    cfg = _port_cfg('fp32', {})
    spec_of = dict(_leaves(tllama.param_partition_specs(cfg)))
    step_dir = os.path.join(port['saves'], saved_on, f'step_{SAVE_STEP}')
    with open(os.path.join(step_dir, tckpt.INDEX_FILE),
              encoding='utf-8') as f:
        index = json.load(f)
    files = {}
    for key, entry in index['leaves'].items():
        covered = torch.zeros(entry['shape'], dtype=torch.int32)
        for piece in entry['pieces']:
            rank = int(piece['file'][len('rank_'):-len('.pt')])
            mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(n),
                                   rank=rank)
            mine = tmesh.spec_to_slices(entry['shape'],
                                        spec_of[key.split('/', 1)[1] + '/'],
                                        mesh)
            assert piece['start'] == [s.start for s in mine], key
            assert piece['shape'] == [s.stop - s.start for s in mine], key
            covered[mine] += 1
            files.setdefault(piece['file'], set()).add(key)
        assert bool((covered == 1).all()), key
    for name, keys in files.items():
        held = torch.load(os.path.join(step_dir, name), map_location='cpu',
                          weights_only=True)
        assert set(held) == keys, name
    written = sorted(f for f in os.listdir(step_dir) if f.startswith('rank_'))
    assert written == sorted(files)
    # A norm replicates everywhere: rank 0 alone writes it.
    norm = index['leaves']['params/layers/attn_norm']['pieces']
    assert [p['file'] for p in norm] == ['rank_00000.pt']


def test_moe_state_saves_and_restores_on_an_expert_mesh(runs):
    """An MoE TrainState (router, experts) saves on an (expert 2) mesh
    of two ranks and restores on one device and as each rank's slices;
    the one-file format's save gathered llama's tree and failed on it."""
    from skypilot_tpu_torch.models import moe as tmoe  # pylint: disable=import-outside-toplevel
    port, _ = runs
    cfg = _moe_cfg()
    _check_restores(os.path.join(port['saves'], 'moe'), cfg,
                    tmoe.param_partition_specs(cfg),
                    {'expert2': MOE_SAVE_MESH,
                     'fsdp2-expert2': (dict(fsdp=2, expert=2), 4)})


def test_one_file_format_still_restores(tmp_path):
    """A step directory in the earlier one-file format (``state.pt``
    with the whole state) restores on one device and as any rank's
    slices, and lists as complete."""
    cfg = _port_cfg('fp32', {})
    whole = _save_state(cfg)
    opt = whole.opt_state
    tckpt._write(str(tmp_path), dict(  # pylint: disable=protected-access
        params=whole.params, mu=opt.mu, nu=opt.nu, count=opt.count,
        step=whole.step), SAVE_STEP, 3)
    assert sorted(os.listdir(tmp_path / f'step_{SAVE_STEP}')) == sorted(
        [tckpt.COMMIT_FILE, tckpt.STATE_FILE])
    assert tckpt.list_steps(str(tmp_path)) == [SAVE_STEP]
    _check_restores(str(tmp_path), cfg, tllama.param_partition_specs(cfg),
                    SAVE_MESHES)


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
