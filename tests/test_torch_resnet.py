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
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.models.resnet',
           '--model', 'debug', '--batch-size', '2', '--image-size', '32',
           '--steps', '2']
    out = subprocess.run(cmd + ['--device', 'cpu'], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['metric'] == 'resnet_train_examples_per_sec'
    assert line['model'] == 'debug' and line['unit'] == 'examples/s'
    assert line['value'] > 0 and np.isfinite(line['loss'])
    assert line['n_devices'] == 1
    for flag in ('--data-parallel', '--distributed'):
        with pytest.raises(SystemExit):
            tresnet.main(['--device', 'cpu', flag])
    if torch.cuda.is_available():
        return
    out = subprocess.run(cmd, cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
