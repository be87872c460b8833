"""The port's training mesh (skypilot_tpu_torch/parallel/mesh.py, the
training half) and its local launcher (parallel/distributed.local_ranks)
against the reference's ``skypilot_tpu/parallel/mesh.py``.

Layouts need no process group: a mesh of N ranks seen from rank r gives
the shapes, coordinates and slices, held against the reference's meshes
over the conftest's 8 virtual CPU devices (device r's place in the
reference's device array is rank r's coordinate; its ``NamedSharding``
index of each param is rank r's slice). The collectives run once, on
four gloo CPU ranks of one ``local_ranks`` call (this process and three
fresh interpreters, one thread each), against numpy. This file imports
JAX only inside the cases that run the reference, so the ranks do not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh

LAYOUTS = [
    ('dp-fsdp-tp', 8, None, dict(data=2, fsdp=-1, model=2)),
    ('fsdp', 4, None, dict()),
    ('fsdp-tp', 4, None, dict(fsdp=2, model=2)),
    ('tp', 2, None, dict(fsdp=1, model=2)),
    ('seq', 8, None, dict(data=2, fsdp=1, seq=2, model=2)),
    ('multislice', 8, 2, dict(data=1, fsdp=2, model=2)),
    ('multislice-fsdp', 4, 2, dict()),
]


def _port(n, slices, kw, rank=0):
    cfg = tmesh.MeshConfig(**kw)
    if slices:
        return tmesh.make_multislice_mesh(slices, cfg, ranks=range(n),
                                          rank=rank)
    return tmesh.make_mesh(cfg, ranks=range(n), rank=rank)


def _reference(n, slices, kw):
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    cfg = jmesh.MeshConfig(**kw)
    devices = jax.devices()[:n]
    if slices:
        return jmesh.make_multislice_mesh(slices, cfg, devices=devices)
    return jmesh.make_mesh(cfg, devices=devices)


def test_make_mesh_infer():
    mesh = _port(8, None, dict(data=2, fsdp=-1, model=2))
    assert mesh.shape == {'data': 2, 'fsdp': 2, 'expert': 1, 'seq': 1,
                          'model': 2}


def test_make_mesh_invalid():
    with pytest.raises(ValueError):
        _port(8, None, dict(data=3, fsdp=-1))  # 8 not divisible by 3
    with pytest.raises(ValueError, match='Only one axis'):
        _port(8, None, dict(data=-1, fsdp=-1))
    with pytest.raises(ValueError, match='does not cover'):
        _port(8, None, dict(data=2, fsdp=2))
    with pytest.raises(ValueError, match='slices'):
        _port(4, 3, dict())


def test_multislice_mesh_axes():
    mesh = _port(8, 2, dict(data=1, fsdp=2, model=2))
    assert mesh.shape['dcn'] == 2 and mesh.axis_names[0] == 'dcn'
    assert mesh.shape['fsdp'] == 2 and mesh.shape['model'] == 2
    assert tmesh.batch_spec(multislice=True) == (('dcn', 'data', 'fsdp'),)


def test_batch_specs_equal_the_reference():
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    for multislice in (False, True):
        assert tmesh.batch_spec(multislice) == tuple(
            jmesh.batch_spec(multislice))
    assert tmesh.batch_seq_spec() == tuple(jmesh.batch_seq_spec())
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.DCN_AXIS == jmesh.DCN_AXIS


@pytest.mark.parametrize('name,n,slices,kw', LAYOUTS,
                         ids=[c[0] for c in LAYOUTS])
def test_rank_coordinates_are_the_reference_device_order(name, n, slices,
                                                         kw):
    del name
    ref = _reference(n, slices, kw)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r in range(n):
        mesh = _port(n, slices, kw, rank=r)
        assert mesh.shape == dict(ref.shape)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(mesh.coords[a] for a in mesh.axis_names) == where


def test_training_specs_equal_the_reference():
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    want = jllama.param_partition_specs(jllama.CONFIGS['debug'])
    got = tllama.param_partition_specs(tllama.CONFIGS['debug'])

    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f'{path}/{k}')
        else:
            assert g == tuple(w), (path, g, w)

    walk(got, want, '')


@pytest.mark.parametrize('name,n,slices,kw',
                         [c for c in LAYOUTS if c[0] != 'seq'],
                         ids=[c[0] for c in LAYOUTS if c[0] != 'seq'])
def test_slices_are_the_reference_shards(name, n, slices, kw):
    """Every param's slice and the batch rows of every rank equal the
    index the reference's NamedSharding gives its device."""
    del name
    _check_slices(n, slices, kw)
    x = torch.arange(8 * 32).reshape(8, 32)
    mesh = _port(n, slices, kw, rank=n - 1)
    spec = (None, tmesh.FSDP_AXIS)
    shard = tmesh.shard_tensor(x, spec, mesh)
    assert torch.equal(shard, x[tmesh.spec_to_slices(x.shape, spec, mesh)])
    assert shard.is_contiguous()


def _check_slices(n, slices, kw):
    from jax.sharding import NamedSharding  # pylint: disable=import-outside-toplevel
    from jax.sharding import PartitionSpec as P  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    ref = _reference(n, slices, kw)
    cfg = tllama.CONFIGS['debug']
    shapes = tllama.param_shapes(cfg)
    leaves = [(k, shapes[k], s) for k, s in
              jllama.param_partition_specs(cfg).items() if k != 'layers']
    leaves += [(k, shapes['layers'][k], s) for k, s in
               jllama.param_partition_specs(cfg)['layers'].items()]
    batch = jmesh.batch_spec(multislice=bool(slices))
    leaves.append(('batch', (8, 32), P(*batch, None)))
    for key, shape, spec in leaves:
        want = NamedSharding(ref, spec).devices_indices_map(shape)
        for device, index in want.items():
            mesh = _port(n, slices, kw, rank=device.id)
            got = [(s.start, s.stop) for s in
                   tmesh.spec_to_slices(shape, tuple(spec), mesh)]
            full = [s.indices(d)[:2] for s, d in zip(index, shape)]
            assert got == full, (key, device.id, got, full)
            if key == 'batch':
                rows = mesh.batch_rows(8)
                assert (rows.start, rows.stop) == got[0]


@pytest.mark.parametrize('case', ['fsdp2-seq2', 'fsdp2-expert2',
                                  'ring_attention'])
def test_seq_and_expert_axes_raise(case):
    """A seq or expert axis no longer raises: on (fsdp 2, seq 2) and
    (fsdp 2, expert 2) every rank's coordinates, param slices and batch
    rows are the reference's (the batch over fsdp only, the params
    replicated along seq and expert), and a training init on such a
    layout keeps those slices. What raises, in both packages, is the
    loss with ring attention and no sequence-sharded context."""
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    if case == 'ring_attention':
        import jax  # pylint: disable=import-outside-toplevel
        import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
        cfg = dataclasses.replace(tllama.CONFIGS['debug'],
                                  ring_attention=True)
        params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
        tokens = torch.zeros((2, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match='unbound axis name: seq'):
            tllama.loss_fn(params, tokens, tokens, cfg)
        jcfg = dataclasses.replace(jllama.CONFIGS['debug'],
                                   ring_attention=True)
        jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        with pytest.raises(NameError, match='unbound axis name: seq'):
            jllama.loss_fn(jparams, jnp.zeros((2, 8), jnp.int32),
                           jnp.zeros((2, 8), jnp.int32), jcfg)
        return
    kw = dict(fsdp=2, seq=2) if case == 'fsdp2-seq2' else dict(fsdp=2,
                                                               expert=2)
    test_rank_coordinates_are_the_reference_device_order(case, 4, None, kw)
    _check_slices(4, None, kw)
    cfg = tllama.CONFIGS['debug']
    gen = torch.Generator().manual_seed(0)
    whole = tllama.init_params(cfg, gen)
    specs = tllama.param_partition_specs(cfg)
    for r in range(4):
        mesh = _port(4, None, kw, rank=r)
        gen.manual_seed(0)
        mine = tllama.init_params(cfg, gen, mesh=mesh)
        assert torch.equal(mine['layers']['wq'], tmesh.shard_tensor(
            whole['layers']['wq'], specs['layers']['wq'], mesh))
        # The replicas along seq or expert hold the same slice.
        assert mine['layers']['wq'].shape == (2, 32, 64)


def _collectives(x):
    """Rank function: each collective of the mesh and each autograd op
    on a (fsdp 2, model 2) mesh, returned for rank 0 to check."""
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, model=2))
    r = mesh.rank
    mine = torch.from_numpy(x[r]).requires_grad_(True)
    out = {
        'coords': dict(mesh.coords),
        'gather_fsdp': mesh.all_gather(mine.detach(), 'fsdp', 1),
        'sum_params': mesh.all_reduce(mine.detach(), tmesh.PARAM_AXES),
        'max_model': mesh.all_reduce(mine.detach(), 'model', 'max'),
        'scatter_params': mesh.reduce_scatter(mine.detach(),
                                              tmesh.PARAM_AXES, 0),
        'bf16_sum': mesh.all_reduce(mine.detach().bfloat16(), 'model'),
        'to_root': mesh.gather_to_root(mine.detach(), (tmesh.FSDP_AXIS,
                                                       tmesh.MODEL_AXIS)),
    }
    seen = [None] * mesh.num_ranks
    torch.distributed.all_gather_object(seen, out['to_root'] is None)
    out['to_root_elsewhere'] = seen
    # A mesh over two of the four ranks (the reference's devices=).
    sub = tmesh.make_mesh(tmesh.MeshConfig(data=2, fsdp=1), ranks=[1, 3])
    got = None if sub is None else (
        sub.rank, sub.all_reduce(mine.detach(), 'data'))
    out['sub'] = [None] * mesh.num_ranks
    torch.distributed.all_gather_object(out['sub'], got)
    # FSDP: the backward of the gather reduce-scatters the grad.
    g = tmesh.gather_shards(mine, mesh, 0)
    (w,) = torch.autograd.grad((g * (r + 1)).sum(), mine)
    out['gather_grad'] = w
    y = tmesh.reduce_from_model(mine * 2, mesh)
    (w,) = torch.autograd.grad((y * (r + 1)).sum(), mine)
    out['reduce_from_model'] = (y.detach(), w)
    y = tmesh.copy_to_model(mine, mesh)
    (w,) = torch.autograd.grad((y * (r + 1)).sum(), mine)
    out['copy_to_model'] = (y.detach(), w)
    y = tmesh.sum_over(mine, mesh, 'fsdp')
    (w,) = torch.autograd.grad((y * (r + 1)).sum(), mine)
    out['sum_over'] = (y.detach(), w)
    return out


def test_collectives_on_four_gloo_ranks():
    """Rank r = fsdp * 2 + model. Sums in fp32, the backward of each
    autograd op as its docstring says."""
    x = np.random.default_rng(0).standard_normal((4, 4, 3)).astype(
        np.float32)
    out = distributed.local_ranks(4, _collectives, (x,), platform='cpu')
    assert out['coords'] == {'data': 0, 'fsdp': 0, 'expert': 0, 'seq': 0,
                             'model': 0}
    # Rank 0's fsdp peer is rank 2, its model peer rank 1.
    np.testing.assert_array_equal(out['gather_fsdp'].numpy(),
                                  np.concatenate([x[0], x[2]], 1))
    np.testing.assert_allclose(out['sum_params'].numpy(), x.sum(0),
                               rtol=1e-6)
    np.testing.assert_array_equal(out['max_model'].numpy(),
                                  np.maximum(x[0], x[1]))
    np.testing.assert_allclose(out['scatter_params'].numpy(),
                               x.sum(0)[:1], rtol=1e-6)
    assert out['bf16_sum'].dtype == torch.bfloat16
    # Each rank's bf16 value, summed in fp32, rounded once.
    bf16 = [torch.from_numpy(v).bfloat16().float() for v in x[:2]]
    np.testing.assert_array_equal(out['bf16_sum'].float().numpy(),
                                  (bf16[0] + bf16[1]).bfloat16().float())
    # Rank 0 gathers [fsdp x model] blocks: rows by fsdp, columns by
    # model; the others get None.
    np.testing.assert_array_equal(
        out['to_root'].numpy(),
        np.block([[x[0], x[1]], [x[2], x[3]]]))
    assert out['to_root_elsewhere'] == [False, True, True, True]
    assert out['sub'][0] is None and out['sub'][2] is None
    for r, mesh_rank in ((1, 0), (3, 1)):
        assert out['sub'][r][0] == mesh_rank
        np.testing.assert_allclose(out['sub'][r][1].numpy(), x[1] + x[3],
                                   rtol=1e-6)
    # d/dx of sum_r (r+1) * gather(x)_r over the fsdp pair {0, 2}: rows
    # of rank 0's slice get 1 + 3.
    np.testing.assert_allclose(out['gather_grad'].numpy(),
                               np.full((4, 3), 4.0))
    y, w = out['reduce_from_model']
    np.testing.assert_allclose(y.numpy(), 2 * (x[0] + x[1]), rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.full((4, 3), 2.0))
    y, w = out['copy_to_model']
    np.testing.assert_array_equal(y.numpy(), x[0])
    np.testing.assert_allclose(w.numpy(), np.full((4, 3), 1.0 + 2.0))
    y, w = out['sum_over']
    np.testing.assert_allclose(y.numpy(), x[0] + x[2], rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.full((4, 3), 1.0 + 3.0))


def _fail_on_rank_2():
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, model=2))
    if mesh.rank == 2:
        raise RuntimeError('rank 2 fails')
    mesh.all_reduce(torch.ones(2), tmesh.PARAM_AXES)


def test_a_failing_rank_fails_the_call():
    """A rank that raises fails local_ranks: its peers see the closed
    connection at their next collective instead of hanging in it."""
    import time  # pylint: disable=import-outside-toplevel
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        distributed.local_ranks(4, _fail_on_rank_2, platform='cpu')
    assert time.perf_counter() - t0 < 120
    assert not torch.distributed.is_initialized()


def test_local_ranks_refuses_nccl_on_cpu_ranks():
    with pytest.raises(ValueError, match='nccl'):
        distributed.local_ranks(2, _fail_on_rank_2, platform='cpu',
                                backend='nccl')
