"""The port's ResNet trainer (skypilot_tpu_torch/models/resnet.py,
models/convert.resnet_params_from_numpy) against the JAX reference's
``skypilot_tpu/models/resnet.py`` on the ``debug`` config in fp32, basic
blocks and bottlenecks, on the reference's own weights bridged through
numpy (HWIO convolutions permuted to OIHW).

Images of 16 x 16 and 19 x 19 put every stride-2 layer (the 7x7 stem,
the 3x3 max pool, the stage's 3x3 conv and 1x1 projection) on an even
and on an odd size, so XLA's asymmetric 'SAME' padding is pinned.

Tolerances (fp32; only the summation order differs: XLA:CPU's
convolutions against oneDNN's): logits within 2e-5 of their largest
|value|; loss rel 2e-5; each grad leaf within 2e-4 of its largest
|value|; after two SGD steps each param and momentum leaf within 2e-4
of its largest |value| and each step's loss rel 2e-5 — the rules of
``tests/test_torch_train.py`` (its grad rule for what carries grads).
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import resnet as jresnet
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import resnet as tresnet

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
F32_GRAD_TOL = 2e-4
BATCH = 4


def _setup(bottleneck, size):
    jcfg = dataclasses.replace(jresnet.CONFIGS['debug'],
                               bottleneck=bottleneck, dtype=jnp.float32)
    tcfg = dataclasses.replace(tresnet.CONFIGS['debug'],
                               bottleneck=bottleneck, dtype=torch.float32)
    jparams = jresnet.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(size)
    images = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, BATCH).astype(np.int32)
    return jcfg, tcfg, jparams, images, labels


def _port_params(jparams, tcfg):
    return convert.resnet_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _hwio(t):
    """A port leaf in the reference's layout, for comparison."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


CASES = [(bottleneck, size) for bottleneck in (False, True)
         for size in (16, 19)]


@pytest.mark.parametrize('bottleneck,size', CASES)
def test_forward_loss_and_grads_match_reference(bottleneck, size):
    jcfg, tcfg, jparams, images, labels = _setup(bottleneck, size)
    tparams = _port_params(jparams, tcfg)
    want_logits = jresnet.forward(jparams, jnp.asarray(images), jcfg)
    got_logits = tresnet.forward(tparams, torch.from_numpy(images), tcfg)
    assert got_logits.shape == (BATCH, jcfg.num_classes)
    assert got_logits.dtype == torch.float32
    _close(got_logits, want_logits, F32_TOL)

    loss, grads = jax.value_and_grad(jresnet.loss_fn)(
        jparams, jnp.asarray(images), jnp.asarray(labels), jcfg)
    leaves = tresnet.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    t_loss = tresnet.loss_fn(tparams, torch.from_numpy(images),
                             torch.from_numpy(labels), tcfg)
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=F32_TOL)
    ref_leaves = jax.tree.leaves(grads)
    assert len(ref_leaves) == len(t_grads)
    for ref, got in zip(ref_leaves, t_grads):
        _close(_hwio(got), ref, F32_GRAD_TOL)


@pytest.mark.parametrize('bottleneck,size', CASES)
def test_two_sgd_steps_match_reference(bottleneck, size):
    jcfg, tcfg, jparams, images, labels = _setup(bottleneck, size)
    tparams = _port_params(jparams, tcfg)
    jstep = jresnet.make_train_step(jcfg)
    tstep = tresnet.make_train_step(tcfg)
    jmom = jresnet.zeros_momentum(jparams)
    tmom = tresnet.zeros_momentum(tparams)
    for _ in range(2):
        jparams, jmom, jloss = jstep(jparams, jmom, jnp.asarray(images),
                                     jnp.asarray(labels))
        tparams, tmom, tloss = tstep(tparams, tmom, images, labels)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=F32_TOL)
    for tree, ref_tree in ((tparams, jparams), (tmom, jmom)):
        for got, ref in zip(tresnet.tree_leaves(tree),
                            jax.tree.leaves(ref_tree)):
            assert got.dtype == torch.float32
            _close(_hwio(got), ref, F32_GRAD_TOL)


def _data_parallel_steps(cases):
    """Rank function: two SGD steps of each case over a 'data' mesh of
    every rank, from the reference's params (numpy); rank 0's losses,
    params and momentum."""
    out = []
    for bottleneck, images, labels, tree in cases:
        tcfg = dataclasses.replace(tresnet.CONFIGS['debug'],
                                   bottleneck=bottleneck,
                                   dtype=torch.float32)
        params = convert.resnet_params_from_numpy(tree, tcfg)
        momentum = tresnet.zeros_momentum(params)
        step = tresnet.make_train_step(tcfg, mesh=tresnet.data_mesh())
        losses = []
        for _ in range(2):
            params, momentum, loss = step(params, momentum, images, labels)
            losses.append(loss.item())
        out.append((losses, [p.clone() for p in
                             tresnet.tree_leaves(params)],
                    [m.clone() for m in tresnet.tree_leaves(momentum)]))
    return out


def test_data_parallel_sync_bn_matches_reference():
    """``make_train_step(mesh=)`` over two gloo CPU ranks against the
    reference's ``make_train_step(mesh=Mesh(devices[:2], ('data',)))``:
    each rank normalises its 2 rows with the global batch's statistics
    (sync BN), so the losses, params and momentum after two steps
    follow the reference's rules above."""
    from jax.sharding import Mesh  # pylint: disable=import-outside-toplevel
    from skypilot_tpu_torch.parallel import distributed  # pylint: disable=import-outside-toplevel
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    setups = [_setup(bottleneck, size) for bottleneck, size in CASES]
    cases = [(bottleneck, images, labels, jax.tree.map(np.asarray, jparams))
             for (bottleneck, _), (_, _, jparams, images, labels)
             in zip(CASES, setups)]

    def reference():
        want = []
        for jcfg, _, jparams, images, labels in setups:
            jstep = jresnet.make_train_step(jcfg, mesh=mesh)
            jmom = jresnet.zeros_momentum(jparams)
            losses = []
            for _ in range(2):
                jparams, jmom, jloss = jstep(jparams, jmom,
                                             jnp.asarray(images),
                                             jnp.asarray(labels))
                losses.append(float(jloss))
            want.append((losses, jparams, jmom))
        return want

    # The reference's steps (JAX, in this process) run on a thread beside
    # the port's two ranks: neither reads the other's results.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        want = pool.submit(reference)
        got = distributed.local_ranks(2, _data_parallel_steps, (cases,),
                                      platform='cpu')
        want = want.result()
    for (losses, params, mom), (jlosses, jparams, jmom) in zip(got, want):
        np.testing.assert_allclose(losses, jlosses, rtol=F32_TOL)
        for tree, ref_tree in ((params, jparams), (mom, jmom)):
            for leaf, ref in zip(tree, jax.tree.leaves(ref_tree)):
                _close(_hwio(leaf), ref, F32_GRAD_TOL)


def test_bf16_params_update_in_fp32_and_cast_back():
    cfg = tresnet.CONFIGS['debug']
    params = tresnet.init_params(cfg, torch.Generator().manual_seed(0))
    momentum = tresnet.zeros_momentum(params)
    before = [p.clone() for p in tresnet.tree_leaves(params)]
    images = torch.randn(2, 16, 16, 3, generator=torch.Generator()
                         .manual_seed(1))
    labels = torch.tensor([1, 7])
    params, momentum, loss = tresnet.make_train_step(cfg)(
        params, momentum, images, labels)
    assert torch.isfinite(loss)
    for p, m, old in zip(tresnet.tree_leaves(params),
                         tresnet.tree_leaves(momentum), before):
        assert p.dtype == old.dtype and m.dtype == torch.float32
        assert torch.equal(p, (old.float() - 0.1 * m).to(p.dtype))


@pytest.mark.parametrize('n,k,stride,pads', [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (19, 7, 2, (3, 3)), (10, 3, 2, (0, 1)), (5, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (7, 1, 2, (0, 0)), (56, 3, 1, (1, 1)),
    (56, 1, 1, (0, 0))])
def test_same_padding_is_xlas(n, k, stride, pads):
    assert tresnet.same_pads(n, k, stride) == pads


def test_params_bridge_checks_shapes():
    jcfg = jresnet.CONFIGS['debug']
    tree = jax.tree.map(np.asarray,
                        jresnet.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = convert.resnet_params_from_numpy(tree, tresnet.CONFIGS['debug'])
    assert isinstance(tparams['stages'], list)
    assert isinstance(tparams['stages'][0], list)
    stem = tparams['stem']
    assert stem.shape == (8, 3, 7, 7)
    assert stem.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        stem.float().permute(2, 3, 1, 0).numpy(),
        np.asarray(tree['stem'], np.float32))
    wrong = dataclasses.replace(tresnet.CONFIGS['debug'], width=16)
    with pytest.raises(ValueError, match='for this config'):
        convert.resnet_params_from_numpy(tree, wrong)
    with pytest.raises(ValueError, match='entries'):
        convert.resnet_params_from_numpy(
            tree, dataclasses.replace(wrong, width=8, stage_sizes=(1, 1, 1)))


def test_cli_on_the_cpu_and_refusals():
    """The CLI on the CPU (one JSON line), a two-process
    ``--distributed --data-parallel`` gang of it (rank 0 alone prints,
    n_devices 2) and, on a host with no card, its refusal to run
    without ``--device cpu``: the four processes run at once."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.models.resnet',
           '--model', 'debug', '--batch-size', '2', '--image-size', '32',
           '--steps', '2']
    # --distributed --data-parallel: a two-process gang (the gang's env
    # triple) splits the batch; rank 0 alone prints, n_devices 2.
    from skypilot_tpu_torch.parallel import distributed  # pylint: disable=import-outside-toplevel
    gang = dict(env, OMP_NUM_THREADS='1', JAX_NUM_PROCESSES='2',
                JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{distributed.free_port()}')
    gang.pop('SKYTPU_DISABLE_JAX_DISTRIBUTED', None)
    runs = [(cmd + ['--device', 'cpu'], env)]
    runs += [(cmd + ['--device', 'cpu', '--distributed', '--data-parallel'],
              dict(gang, JAX_PROCESS_ID=str(r))) for r in range(2)]
    refusal = not torch.cuda.is_available()
    if refusal:
        runs.append((cmd, env))
    procs = [subprocess.Popen(c, cwd=REPO_ROOT, env=e,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in runs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs[:3], outs):
        assert p.returncode == 0, err[-3000:]
    line = json.loads(outs[0][0].strip().splitlines()[-1])
    assert line['metric'] == 'resnet_train_examples_per_sec'
    assert line['model'] == 'debug' and line['unit'] == 'examples/s'
    assert line['value'] > 0 and np.isfinite(line['loss'])
    assert line['n_devices'] == 1
    dp = json.loads(outs[1][0].strip().splitlines()[-1])
    assert dp['n_devices'] == 2 and np.isfinite(dp['loss'])
    assert not outs[2][0].strip()
    if refusal:
        assert procs[3].returncode != 0
        assert "device='cpu'" in outs[3][1]