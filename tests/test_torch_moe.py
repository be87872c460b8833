"""The port's mixture of experts (skypilot_tpu_torch/models/moe.py)
against the reference's ``skypilot_tpu/models/moe.py`` on the
``moe-debug`` config, from the reference's own params (bridged through
``convert.params_from_numpy``):

* ``_route`` on random rows: dispatch equal, combine within 1e-6, the
  aux loss within 1e-6;
* ``forward`` (logits and aux) and ``loss_fn`` with its grads, fp32
  within 2e-5 (grads within 2e-5 of each leaf's largest |value|), with
  and without remat + the flash path (the twins here, the reference's
  dense fallback);
* the same loss and grads on (data 2, expert 2), (fsdp 2, expert 2)
  and (expert 2) meshes of gloo CPU ranks (one ``local_ranks`` call of
  four ranks), against the reference's ``value_and_grad(loss_fn)`` jitted
  over its (data 2, expert 2) mesh of 4 virtual devices as
  ``tests/unit_tests/test_moe.py`` runs it;
* a 'model' axis is refused, and so is an expert count the 'expert'
  axis does not split.

This file imports JAX only inside the fixtures and cases that run the
reference, so the ranks do not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import moe as tmoe
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh

F32_TOL = 2e-5
ROUTE_TOL = 1e-6
BATCH, SEQ = 8, 16
# name → (ranks, MeshConfig kwargs)
MESHES = {
    'data2-expert2': (4, dict(data=2, fsdp=1, expert=2)),
    'fsdp2-expert2': (4, dict(fsdp=2, expert=2)),
    'expert2': (2, dict(fsdp=1, expert=2)),
}
VARIANTS = {'plain': dict(), 'remat-flash': dict(remat=True,
                                                 flash_attention=True)}


def _port_cfg(**overrides):
    return dataclasses.replace(tmoe.CONFIGS['moe-debug'], dtype=torch.float32,
                               **overrides)


def _reference_cfg(**overrides):
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import moe as jmoe  # pylint: disable=import-outside-toplevel
    return dataclasses.replace(jmoe.CONFIGS['moe-debug'], dtype=jnp.float32,
                               **overrides)


def _batch():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (BATCH, SEQ), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _np_tree(tree):
    return ttrain.tree_map(lambda t: None if t is None else t.float().numpy(),
                           tree)


def _mesh_runs(tree):
    """Rank function: the loss and grads of ``train.value_and_grad`` on
    every mesh of MESHES (a mesh of two ranks leaves ranks 2-3 idle),
    gathered to rank 0."""
    cfg = _port_cfg()
    specs = tmoe.param_partition_specs(cfg)
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    out = {}
    for name, (n, kw) in MESHES.items():
        mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), ranks=range(n))
        if mesh is None:
            continue
        params = tmesh.shard_params(convert.params_from_numpy(tree, cfg),
                                    mesh, specs)
        rows = mesh.batch_rows(BATCH)
        loss, grads = ttrain.value_and_grad(params, tokens[rows],
                                            targets[rows], cfg, mesh)
        out[name] = dict(loss=float(loss), grads=_np_tree(
            ttrain.gather_tree(grads, mesh, specs)),
                         local_we1=tuple(params['layers']['we1'].shape))
    return out


@pytest.fixture(scope='module')
def reference():
    """The reference's params (numpy), its one-device readings by
    variant, and its loss and grads over a (data 2, expert 2) mesh."""
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import moe as jmoe  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    tokens, targets = _batch()
    out = {}
    params = None
    for name, overrides in VARIANTS.items():
        cfg = _reference_cfg(**overrides)
        params = jmoe.init_params(jax.random.PRNGKey(0), cfg)
        logits, aux = jax.jit(lambda p, t, c=cfg: jmoe.forward(p, t, c))(
            params, tokens)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t, g, c=cfg: jmoe.loss_fn(p, t, g, c)))(
                params, tokens, targets)
        out[name] = dict(logits=np.asarray(logits), aux=float(aux),
                         loss=float(loss), grads=jax.tree.map(np.asarray,
                                                              grads))
    cfg = _reference_cfg()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=2, fsdp=1, expert=2,
                                            model=1),
                           devices=jax.devices()[:4])
    sharded = jmesh.shard_params(params, mesh,
                                 jmoe.param_partition_specs(cfg))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t, g: jmoe.loss_fn(p, t, g, cfg)))(sharded, tokens,
                                                        targets)
    out['mesh'] = dict(loss=float(loss),
                       grads=jax.tree.map(np.asarray, grads))
    out['params'] = jax.tree.map(np.asarray, params)
    return out


@pytest.fixture(scope='module')
def mesh_runs(reference):
    return distributed.local_ranks(4, _mesh_runs, (reference['params'],),
                                   platform='cpu')


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f'{k}/{n}', x) for k in sorted(tree)
                for n, x in _leaves(tree[k])]
    return [('', tree)]


def _check_grads(got, want):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_TOL * np.abs(w).max(),
                                   err_msg=path)


def test_route_matches_the_reference():
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import moe as jmoe  # pylint: disable=import-outside-toplevel
    cfg = _port_cfg()
    h = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, cfg.dim)))
    router = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                        (cfg.dim, cfg.n_experts)))
    # Rows leaning one way and an expert that likes it: more first
    # choices of expert 0 than its 40 slots, so the drop is exercised.
    h += 0.5
    router[:, 0] = np.abs(router[:, 0])
    want = jmoe._route(h, router, _reference_cfg())  # pylint: disable=protected-access
    got = tmoe._route(torch.from_numpy(h), torch.from_numpy(router), cfg)  # pylint: disable=protected-access
    capacity = int(cfg.top_k * 64 / cfg.n_experts * cfg.capacity_factor)
    assert tuple(got[0].shape) == (64, cfg.n_experts, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]),
                               rtol=ROUTE_TOL)
    # Some tokens overflow their expert (the drop is exercised).
    assert int(got[0].sum()) < 64 * cfg.top_k


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_forward_loss_and_grads_match_the_reference(reference, variant):
    want = reference[variant]
    cfg = _port_cfg(**VARIANTS[variant])
    params = convert.params_from_numpy(reference['params'], cfg)
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        logits, aux = tmoe.forward(params, tokens, cfg)
    np.testing.assert_allclose(logits.numpy(), want['logits'], rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), want['aux'], rtol=F32_TOL)
    loss, grads = ttrain.value_and_grad(params, tokens, targets, cfg)
    np.testing.assert_allclose(float(loss), want['loss'], rtol=F32_TOL)
    _check_grads(_np_tree(grads), want['grads'])
    assert float(grads['layers']['router'].abs().max()) > 0


@pytest.mark.parametrize('name', sorted(MESHES))
def test_mesh_loss_and_grads_match_the_reference(reference, mesh_runs,
                                                 name):
    got, want = mesh_runs[name], reference['mesh']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=F32_TOL)
    np.testing.assert_allclose(got['loss'], reference['plain']['loss'],
                               rtol=F32_TOL)
    _check_grads(got['grads'], want['grads'])
    ranks, kw = MESHES[name]
    del ranks
    n_local = tmoe.CONFIGS['moe-debug'].n_experts // kw['expert']
    assert got['local_we1'][1] == n_local


def test_unported_meshes_are_refused():
    cfg = _port_cfg()
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=1, expert=2, model=2),
                           ranks=range(4))
    with pytest.raises(NotImplementedError, match='model'):
        ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=1, expert=8),
                           ranks=range(8))
    with pytest.raises(ValueError, match='experts'):
        ttrain.make_train_step(_port_cfg(n_experts=4), ttrain.TrainConfig(),
                               mesh)
