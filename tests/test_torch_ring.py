"""The port's ring attention (skypilot_tpu_torch/parallel/ring.py, with
``ops/attention.ring_attention`` and ``llama.full_sequence_attention``'s
``seq_axis_sharded``) against the reference's
``skypilot_tpu/parallel/ring.py`` ``ring_attention``, GQA (H 4, Hkv 2),
fp32 on a (seq 4) mesh and on a (fsdp 2, seq 2) mesh, bf16 on (seq 4):
the port on four gloo CPU ranks of one ``local_ranks`` call, the
reference over 4 of the conftest's virtual devices. The output and
``grad``'s dq/dk/dv of ``sum(out * w)`` agree within 2e-5 in fp32 and
one bf16 ulp of the largest value in bf16; each rank's shard through
``full_sequence_attention`` equals its slice of the global result; a
ring without a mesh raises, as an unbound axis name does in the
reference.

This file imports JAX only inside the fixtures and cases that run the
reference, so the ranks do not.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import attention as tattention
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.parallel import ring as tring

F32_TOL = 2e-5
B, S, H, HKV, D = 2, 32, 4, 2, 16
# name → (MeshConfig kwargs, dtype)
MESHES = {'seq4': (dict(fsdp=1, seq=4), 'fp32'),
          'fsdp2-seq2': (dict(fsdp=2, seq=2), 'fp32'),
          'seq4-bf16': (dict(fsdp=1, seq=4), 'bf16')}
OUTPUTS = ('out', 'dq', 'dk', 'dv')
DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}


def _inputs():
    rng = np.random.default_rng(5)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                               (B, S, H, D)))


def _rank_runs(arrays):
    """Rank function: on each mesh of MESHES, the global output and the
    global dq/dk/dv of sum(out * w) (the same on every rank), and this
    rank's shard through llama.full_sequence_attention."""
    out = {}
    for name, (kw, dtype) in MESHES.items():
        mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw))
        q, k, v, w = (torch.from_numpy(a) for a in arrays)
        q, k, v = (t.to(DTYPES[dtype]).requires_grad_() for t in (q, k, v))
        got = tring.ring_attention(q, k, v, mesh)
        grads = torch.autograd.grad((got.float() * w).sum(), (q, k, v))
        spec = (('data', 'fsdp'), 'seq', 'model', None)
        shards = [tmesh.shard_tensor(t.detach(), spec, mesh)
                  for t in (q, k, v)]
        with torch.no_grad():
            local = tllama.full_sequence_attention(
                tllama.CONFIGS['debug'], *shards, seq_axis_sharded=True,
                mesh=mesh)
        mine = tmesh.shard_tensor(got.detach(), spec, mesh)
        same = [None] * mesh.num_ranks
        torch.distributed.all_gather_object(
            same, bool(torch.equal(local, mine)))
        out[name] = dict(zip(OUTPUTS, [got.detach().float()] +
                             [g.float() for g in grads]), shard_equal=same)
    return out


@pytest.fixture(scope='module')
def runs():
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import mesh as jmesh  # pylint: disable=import-outside-toplevel
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.parallel import ring as jring  # pylint: disable=import-outside-toplevel
    arrays = _inputs()
    want = {}
    for name, (kw, dtype) in MESHES.items():
        mesh = jmesh.make_mesh(jmesh.MeshConfig(**kw),
                               devices=jax.devices()[:4])
        jdtype = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
        q, k, v = (jnp.asarray(a, jdtype) for a in arrays[:3])
        w = arrays[3]

        def loss(q, k, v, mesh=mesh, w=w):
            out = jring.ring_attention(q, k, v, mesh)
            return (out.astype(jnp.float32) * w).sum()

        out = jax.jit(lambda q, k, v, mesh=mesh: jring.ring_attention(
            q, k, v, mesh))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        want[name] = dict(zip(OUTPUTS, [np.asarray(out, np.float32)] +
                              [np.asarray(g, np.float32) for g in grads]))
    port = distributed.local_ranks(4, _rank_runs, (arrays,), platform='cpu')
    return port, want


@pytest.mark.parametrize('name', sorted(MESHES))
@pytest.mark.parametrize('what', OUTPUTS)
def test_ring_matches_the_reference(runs, name, what):
    """fp32 within 2e-5; bf16 within one bf16 ulp of the largest |value|
    (out and dq read bit-equal; dk/dv sum a KV head's group a ring step
    at a time here and once at the end in the reference, which repeats
    K/V before the ring, so they round in another order)."""
    port, want = runs
    w = want[name][what]
    atol = F32_TOL
    if MESHES[name][1] == 'bf16':
        atol = 2.0**(np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(port[name][what].numpy(), w, rtol=0,
                               atol=atol)


@pytest.mark.parametrize('name', sorted(MESHES))
def test_each_shard_through_full_sequence_attention(runs, name):
    port, _ = runs
    assert port[name]['shard_equal'] == [True] * 4


def test_ring_without_a_mesh_raises():
    q = torch.zeros((1, 8, H, D))
    k = torch.zeros((1, 8, HKV, D))
    with pytest.raises(ValueError, match='unbound axis name: seq'):
        tattention.ring_attention(q, k, k, None, 'seq')
    with pytest.raises(ValueError, match='unbound axis name: seq'):
        tllama.full_sequence_attention(tllama.CONFIGS['debug'], q, k, k,
                                       seq_axis_sharded=True)
