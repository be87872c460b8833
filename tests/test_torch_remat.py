"""The port's selective remat policies (skypilot_tpu_torch/models/llama.py
``remat_block``) against the JAX reference's, on the ``debug`` config.

For each of the five policies, with flash attention (the port's plain
twins on the CPU) and without:

* loss and grads equal the reference's ``jax.value_and_grad`` under the
  same policy, at ``tests/test_torch_train.py``'s fp32 tolerances (loss
  rel 2e-5, each grad leaf within 2e-4 of its largest |value|) and, in
  bf16, its bf16 bounds;
* the port's loss and grads are bit-equal to its own ``'full'`` result:
  a policy changes what backward keeps, never a value;
* what backward keeps of a block equals the reference's residuals. The
  reference's come from ``jax.ad_checkpoint``'s ``saved_residuals`` on
  its loss (its per-layer stacks ``[L, B, S, width]``), with the Pallas
  flash kernel forced on (``_resolve_interpret`` patched to True, so
  the grad jaxpr holds the interpret-mode kernel, not the XLA
  fallback). The port's are the storages that one ``remat_block`` call
  creates and that are still alive when it returns (recorded by a
  ``TorchDispatchMode`` as ``StorageWeakRef``s), less its output, plus
  its input, which checkpointing keeps. The same set is kept on an
  (fsdp 2) mesh of two gloo CPU ranks (one ``local_ranks`` call), where
  each block gathers its weights inside the checkpointed region, and no
  kept tensor has a gathered weight's shape.

This file imports JAX only inside the functions that run the reference,
so the ranks do not.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

POLICIES = ('full', 'dots', 'ffn', 'ffn1', 'attn')
F32_TOL = 2e-5
F32_GRAD_TOL = 2e-4
BF16 = dict(loss=2e-3, grad=3e-2)
# The saved-set check's block input is [B, S, dim]: B differs from the
# debug config's 2 layers, so a stacked [L, B, S, w] residual is known
# by its shape.
B, S = 3, 32
# The per-layer stacks the reference keeps (debug: dim 64, kv 32, ffn
# 128), by width: the block input, then the GEMM outputs or attn_out.
REFERENCE_SAVED = {'full': [64],
                   'dots': [32, 32, 64, 64, 64, 128, 128],
                   'ffn': [64, 128, 128],
                   'ffn1': [64, 128],
                   'attn': [64, 64]}


def _port_cfg(policy, flash, dtype_name='fp32'):
    tcfg = dataclasses.replace(tllama.CONFIGS['debug'], remat=True,
                               remat_policy=policy, flash_attention=flash)
    if dtype_name == 'fp32':
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return tcfg


def _configs(policy, flash, dtype_name='fp32'):
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    jcfg = dataclasses.replace(jllama.CONFIGS['debug'], remat=True,
                               remat_policy=policy, flash_attention=flash)
    if dtype_name == 'fp32':
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    return jcfg, _port_cfg(policy, flash, dtype_name)


def _batch():
    """``tests/test_torch_train.py``'s batch (B 2, S 32, seed 1)."""
    return ttrain.synthetic_batch(256, 2, S, 1, 0)


def _port_value_and_grad(tparams, tcfg):
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    leaves = ttrain.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(tparams, tokens, targets, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize('flash', [True, False])
@pytest.mark.parametrize('policy', POLICIES)
@pytest.mark.parametrize('dtype_name', ['fp32', 'bf16'])
def test_loss_and_grads_match_reference_under_policy(dtype_name, policy,
                                                     flash):
    import jax  # pylint: disable=import-outside-toplevel
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    jcfg, tcfg = _configs(policy, flash, dtype_name)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg)
    tokens, targets = _batch()
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    t_loss, t_grads = _port_value_and_grad(tparams, tcfg)
    leaves = jax.tree.leaves(grads)
    assert len(leaves) == len(t_grads)
    if dtype_name == 'fp32':
        np.testing.assert_allclose(t_loss.item(), float(loss), rtol=F32_TOL)
        for ref, got in zip(leaves, t_grads):
            ref = _f32(ref)
            np.testing.assert_allclose(_f32(got), ref, rtol=0,
                                       atol=F32_GRAD_TOL *
                                       np.abs(ref).max())
    else:
        assert abs(t_loss.item() - float(loss)) <= BF16['loss']
        for ref, got in zip(leaves, t_grads):
            ref, got = _f32(ref), _f32(got)
            assert (np.linalg.norm(got - ref) <=
                    BF16['grad'] * np.linalg.norm(ref))
            assert np.abs(got - ref).max() <= BF16['grad'] * np.abs(ref).max()


@pytest.mark.parametrize('flash', [True, False])
@pytest.mark.parametrize('policy', POLICIES[1:])
def test_policy_is_bit_equal_to_full(policy, flash):
    """bf16, the trainer's dtype: loss and every grad bit for bit."""
    full_cfg = _port_cfg('full', flash, 'bf16')
    tcfg = _port_cfg(policy, flash, 'bf16')
    params = tllama.init_params(full_cfg, torch.Generator().manual_seed(0))
    want_loss, want = _port_value_and_grad(params, full_cfg)
    got_loss, got = _port_value_and_grad(params, tcfg)
    assert torch.equal(got_loss, want_loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _reference_saved(policy, flash, monkeypatch):
    """Widths of the reference's per-layer residual stacks."""
    import jax  # pylint: disable=import-outside-toplevel
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from jax._src.ad_checkpoint import saved_residuals  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.ops import flash_attention as jflash  # pylint: disable=import-outside-toplevel
    monkeypatch.setattr(jflash, '_resolve_interpret', lambda _: True)
    jcfg, _ = _configs(policy, flash, 'bf16')
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = jnp.zeros((B, S), jnp.int32)
    res = saved_residuals(
        lambda p: jllama.loss_fn(p, tokens, tokens, jcfg), params)
    stacked = (jcfg.n_layers, B, S)
    return sorted(aval.shape[-1] for aval, _ in res
                  if aval.ndim == 4 and aval.shape[:3] == stacked)


class _Outputs(TorchDispatchMode):
    """Every op's output storages, as weak references, with each
    output's element count and shape."""

    def __init__(self):
        super().__init__()
        self.storages = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.storages.append((StorageWeakRef(t.untyped_storage()),
                                      t.numel(), tuple(t.shape)))
        return out


def _port_saved(policy, flash, mesh=None):
    """(widths, shapes) of what one block's backward keeps: the storages
    its forward made that outlive the call, less its output, plus its
    input. On a ``mesh`` the block takes this rank's slices of layer 0
    and gathers them inside."""
    tcfg = _port_cfg(policy, flash, 'bf16')
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                mesh=mesh)
    layer = {k: w.requires_grad_(True)
             for k, w in tllama.layer_params(params, 0).items()}
    cos, sin = tllama._rope_freqs(tcfg, torch.arange(S))
    x = torch.randn(B, S, tcfg.dim).to(tcfg.dtype).requires_grad_(True)
    mode = _Outputs()
    with mode:
        out = tllama.remat_block(tcfg, x, layer, cos, sin, mesh=mesh)
    gc.collect()
    known = {StorageWeakRef(t.untyped_storage()).cdata
             for t in [x, cos, sin, out, *layer.values()]}
    alive = {}
    for ref, numel, shape in mode.storages:
        if not ref.expired() and ref.cdata not in known:
            alive[ref.cdata] = (numel // (B * S), shape)
    out.float().sum().backward()     # the graph still runs
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    return (sorted([w for w, _ in alive.values()] + [tcfg.dim]),
            sorted(shape for _, shape in alive.values()))


def _gathered_shapes():
    """A layer's weights as a block gathers them over fsdp: their whole
    per-layer shapes."""
    shapes = tllama.param_shapes(tllama.CONFIGS['debug'])['layers']
    return {tuple(shape[1:]) for shape in shapes.values()}


def _mesh_saved_sets():
    """Rank function: ``_port_saved`` of every policy, with and without
    flash, on an (fsdp 2) mesh; every rank's readings."""
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2))
    mine = {(policy, flash): _port_saved(policy, flash, mesh)
            for policy in POLICIES for flash in (True, False)}
    seen = [None] * mesh.num_ranks
    torch.distributed.all_gather_object(seen, mine)
    return seen


@pytest.fixture(scope='module')
def mesh_saved():
    return distributed.local_ranks(2, _mesh_saved_sets, platform='cpu')


@pytest.mark.parametrize('flash', [True, False])
@pytest.mark.parametrize('policy', POLICIES)
def test_saved_set_matches_reference(policy, flash, monkeypatch,
                                     mesh_saved):
    """The one-device set equals the reference's; on an (fsdp 2) mesh
    every rank keeps the same widths, none of them a gathered weight."""
    want = _reference_saved(policy, flash, monkeypatch)
    assert want == REFERENCE_SAVED[policy]
    assert _port_saved(policy, flash)[0] == want
    gathered = _gathered_shapes()
    for rank in mesh_saved:
        widths, shapes = rank[(policy, flash)]
        assert widths == want
        assert not gathered & set(shapes), shapes


def test_unknown_policy_raises():
    cfg = dataclasses.replace(tllama.CONFIGS['debug'], remat=True,
                              remat_policy='everything')
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match='unknown remat_policy'):
        tllama.loss_fn(params, tokens, targets, cfg)
