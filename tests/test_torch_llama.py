"""Port model (skypilot_tpu_torch/models/llama.py, convert.py,
ops/attention.py) against the JAX reference on the ``debug`` config.

Weights are the reference's own ``llama.init_params`` output, bridged
through ``convert.params_from_numpy``. Tolerances: fp32 logits atol/rtol
2e-5 (summation order only); bf16 logits atol 1.6e-2 — two bf16 ulps of
the debug model's |logits| < 1, since both frameworks round every
matmul output to bf16 but may accumulate in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import attention as jattention
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import attention as tattention

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_ATOL = 1.6e-2


def _configs(dtype_name):
    jcfg = jllama.CONFIGS['debug']
    tcfg = tllama.CONFIGS['debug']
    if dtype_name == 'fp32':
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _bridged(dtype_name, seed=0):
    jcfg, tcfg = _configs(dtype_name)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def test_params_from_numpy_is_bit_exact():
    _, tcfg, jparams, tparams = _bridged('bf16')
    for name in ('tok_embedding', 'lm_head'):
        ref = np.asarray(jparams[name])
        assert tparams[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tparams[name].view(torch.int16).numpy(),
            ref.view(np.int16))
    wq = np.asarray(jparams['layers']['wq'])
    np.testing.assert_array_equal(
        tparams['layers']['wq'].view(torch.int16).numpy(),
        wq.view(np.int16))
    assert tparams['layers']['wq'].shape == (tcfg.n_layers, tcfg.dim,
                                             tcfg.dim)
    bad = jax.tree.map(np.asarray, jparams)
    bad['lm_head'] = bad['lm_head'][:, :-1]
    with pytest.raises(ValueError, match='lm_head'):
        convert.params_from_numpy(bad, tcfg)


@pytest.mark.parametrize('dtype_name', ['fp32', 'bf16'])
def test_forward_logits_match_reference(dtype_name):
    jcfg, tcfg, jparams, tparams = _bridged(dtype_name)
    tokens = np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    out = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    if dtype_name == 'fp32':
        np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=BF16_ATOL,
                                   rtol=0)


def test_forward_with_position_offset_matches_reference():
    jcfg, tcfg, jparams, tparams = _bridged('fp32', seed=3)
    tokens = np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (1, 9)).astype(np.int32)
    pos = np.arange(9, dtype=np.int32) + 40
    ref = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                                    jnp.asarray(pos)))
    out = tllama.forward(tparams, torch.from_numpy(tokens), tcfg,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize('dtype_name', ['fp32', 'bf16'])
def test_gqa_attention_matches_reference(dtype_name):
    """The prefill attention: grouped GQA, fp32 softmax, probs in the
    input dtype before PV."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 12, 8, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype_name == 'fp32'
                else (jnp.bfloat16, torch.bfloat16))
    ref = jattention.gqa_attention(*(jnp.asarray(a).astype(jdt)
                                     for a in (q, k, v)))
    out = tattention.gqa_attention(*(torch.from_numpy(a).to(tdt)
                                     for a in (q, k, v)))
    tol = F32_TOL if dtype_name == 'fp32' else BF16_ATOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # repeat_kv is the fan-out order the grouping must reproduce.
    np.testing.assert_array_equal(
        tattention.repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(jattention.repeat_kv(jnp.asarray(k), 4)))


def test_rms_norm_and_rope_match_reference():
    jcfg, tcfg = _configs('bf16')
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 4, tcfg.head_dim).astype(np.float32)
    w = rng.randn(tcfg.head_dim).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(x).bfloat16()
    ref = jllama.rms_norm(xb, jnp.asarray(w).astype(jnp.bfloat16), 1e-5)
    out = tllama.rms_norm(tb, torch.from_numpy(w).bfloat16(), 1e-5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=BF16_ATOL)
    pos = np.arange(5, dtype=np.int32) + 100
    jcos, jsin = jllama._rope_freqs(jcfg, jnp.asarray(pos))  # pylint: disable=protected-access
    tcos, tsin = tllama._rope_freqs(tcfg, torch.from_numpy(pos))  # pylint: disable=protected-access
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)
    ref = jllama.apply_rope(jnp.asarray(x), jcos, jsin)
    out = tllama.apply_rope(torch.from_numpy(x), tcos, tsin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
