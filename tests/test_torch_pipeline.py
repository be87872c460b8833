"""The port's GPipe (skypilot_tpu_torch/parallel/pipeline.py) against the
reference's ``skypilot_tpu/parallel/pipeline.py`` on the ``debug``
config in fp32, on a (data 2, stage 2) mesh with 4 microbatches: the
port on four gloo CPU ranks of one ``local_ranks`` call, the reference
over 4 of the conftest's virtual devices, from the reference's params
(bridged through ``convert.params_from_numpy`` and sliced stage-wise):

* ``pipeline_loss_fn`` and its grads (loss rel 2e-5, grads within 2e-5
  of each leaf's largest |value|);
* 3 steps of ``make_pp_train_step`` with remat and 2 cross-entropy
  chunks: each step's loss (rel 2e-5) and the params after (atol 2e-5);
* the specs, and ``init_pp_train_state`` drawing what one rank's
  ``llama.init_params`` draws, each stage keeping its layers.

This file imports JAX only inside the fixtures and cases that run the
reference, so the ranks do not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.parallel import pipeline as tpipe

F32_TOL = 2e-5
STAGES, DATA, MICRO = 2, 2, 4
BATCH, SEQ = 8, 16
STEPS = 3
STEP_OVERRIDES = dict(remat=True, ce_chunks=2)


def _train_cfg():
    return ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)


def _port_cfg(**overrides):
    return dataclasses.replace(tllama.CONFIGS['debug'], dtype=torch.float32,
                               **overrides)


def _batches():
    return [ttrain.synthetic_batch(256, BATCH, SEQ, 2, step)
            for step in range(STEPS)]


def _np_tree(tree):
    return ttrain.tree_map(lambda t: None if t is None else t.float().numpy(),
                           tree)


def _rank_runs(tree):
    """Rank function: the loss and grads of the pipelined loss, then
    STEPS train steps, from the reference's params; the grads and final
    params gathered to rank 0, with every rank's layer count."""
    mesh = tpipe.make_pp_mesh(STAGES, DATA)
    specs = tpipe.pp_param_partition_specs(None)
    out = {}
    cfg = _port_cfg()
    params = tmesh.shard_params(convert.params_from_numpy(tree, cfg), mesh,
                                specs)
    tokens, targets = (torch.from_numpy(a) for a in _batches()[0])
    loss, grads = tpipe.value_and_grad(params, tokens, targets, cfg, mesh,
                                       MICRO)
    out['loss'] = float(loss)
    out['grads'] = _np_tree(ttrain.gather_tree(grads, mesh, specs))
    cfg = _port_cfg(**STEP_OVERRIDES)
    state = ttrain.TrainState(params, ttrain.make_optimizer(
        _train_cfg()).init(params), 0)
    step = tpipe.make_pp_train_step(cfg, _train_cfg(), mesh, MICRO)
    out['losses'] = []
    for tokens, targets in _batches():
        state, metrics = step(state, tokens, targets)
        out['losses'].append(float(metrics['loss']))
    out['params'] = _np_tree(ttrain.gather_tree(state.params, mesh, specs))
    layers = [None] * mesh.num_ranks
    torch.distributed.all_gather_object(
        layers, state.params['layers']['wq'].shape[0])
    out['layers'] = layers
    return out


@pytest.fixture(scope='module')
def runs():
    """(the port's readings, the reference's)."""
    import jax  # pylint: disable=import-outside-toplevel
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import train as jtrain  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import pipeline as jpipe  # pylint: disable=import-outside-toplevel
    mesh = jpipe.make_pp_mesh(STAGES, DATA, devices=jax.devices()[:4])
    cfg = dataclasses.replace(jllama.CONFIGS['debug'], dtype=jnp.float32)
    tc = jtrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = jpipe.init_pp_train_state(jax.random.PRNGKey(0), cfg, tc, mesh)
    tree = jax.tree.map(np.asarray, state.params)
    tokens, targets = _batches()[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, g: jpipe.pipeline_loss_fn(p, t, g, cfg, mesh,
                                               MICRO)))(state.params,
                                                        tokens, targets)
    want = dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads))
    step = jpipe.make_pp_train_step(
        dataclasses.replace(cfg, **STEP_OVERRIDES), tc, mesh, MICRO)
    want['losses'] = []
    for tokens, targets in _batches():
        state, metrics = step(state, tokens, targets)
        want['losses'].append(float(metrics['loss']))
    want['params'] = jax.tree.map(np.asarray, state.params)
    port = distributed.local_ranks(STAGES * DATA, _rank_runs, (tree,),
                                   platform='cpu')
    return port, want


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f'{k}/{n}', x) for k in sorted(tree)
                for n, x in _leaves(tree[k])]
    return [('', tree)]


def test_pipeline_loss_and_grads_match_the_reference(runs):
    port, want = runs
    np.testing.assert_allclose(port['loss'], want['loss'], rtol=F32_TOL)
    for (path, g), (_, w) in zip(_leaves(port['grads']),
                                 _leaves(want['grads'])):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_TOL * np.abs(w).max(),
                                   err_msg=path)


def test_pp_train_steps_match_the_reference(runs):
    port, want = runs
    np.testing.assert_allclose(port['losses'], want['losses'], rtol=F32_TOL)
    for (path, g), (_, w) in zip(_leaves(port['params']),
                                 _leaves(want['params'])):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL, err_msg=path)


def test_each_stage_holds_its_layers(runs):
    port, _ = runs
    assert port['layers'] == [1] * (STAGES * DATA)


def test_specs_and_mesh_match_the_reference():
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import pipeline as jpipe  # pylint: disable=import-outside-toplevel
    want = jpipe.pp_param_partition_specs(jllama.CONFIGS['debug'])
    got = tpipe.pp_param_partition_specs(tllama.CONFIGS['debug'])
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert tuple(g[:len(w)]) == tuple(w), path
        assert all(a is None for a in g[len(w):]), path
    assert tpipe.STAGE_AXIS == jpipe.STAGE_AXIS
    ref = jpipe.make_pp_mesh(STAGES, DATA, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r in range(STAGES * DATA):
        mesh = tpipe.make_pp_mesh(STAGES, DATA, ranks=range(4), rank=r)
        assert mesh.shape == dict(ref.shape)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(mesh.coords[a] for a in mesh.axis_names) == where
    with pytest.raises(ValueError):
        tpipe.make_pp_mesh(3, 1, ranks=range(4))


def test_init_draws_one_rank_params_stage_wise():
    cfg = _port_cfg(n_layers=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    whole = tllama.init_params(cfg, gen)
    for r in range(4):
        mesh = tpipe.make_pp_mesh(4, 1, ranks=range(4), rank=r)
        state = tpipe.init_pp_train_state(cfg, _train_cfg(), mesh, 'cpu')
        for name, w in whole['layers'].items():
            assert torch.equal(state.params['layers'][name], w[r:r + 1])
        for name in ('tok_embedding', 'lm_head', 'out_norm'):
            assert torch.equal(state.params[name], whole[name])
