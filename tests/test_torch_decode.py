"""Port decode (skypilot_tpu_torch/models/decode.py) against the JAX
reference (skypilot_tpu/models/decode.py) on the ``debug`` config, bf16,
with the reference's own weights bridged through numpy.

Greedy tokens must be identical (mirrors tests/unit_tests/test_decode.py:
full-forward agreement, ragged prompts, EOS masking, int8 KV, the
over-budget ValueError). Logits of the paged prefill, the prefix-
skipping prefill and the decode steps agree within BF16_ATOL: two bf16
ulps of the debug model's |logits| < 1 (every matmul output is rounded
to bf16 on both sides, in another accumulation order). The int8 pool a
paged prefill writes equals the reference's jitted one bit for bit in
layer 0, and in every layer with XLA's excess precision off.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
TCFG = tllama.CONFIGS['debug']
BF16_ATOL = 1.6e-2


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG)


def _prompt(seed, b, s):
    return np.random.RandomState(seed).randint(
        0, TCFG.vocab_size, (b, s)).astype(np.int32)


def _both(params, prompt, lens, n_new, **dcfg):
    jp, tp = params
    ref = np.asarray(jdecode.generate(
        jp, jnp.asarray(prompt), jnp.asarray(lens), JCFG,
        jdecode.DecodeConfig(**dcfg), n_new))
    tdcfg = {k: ('plain' if v == 'xla' else v) for k, v in dcfg.items()}
    out = tdecode.generate(tp, torch.from_numpy(prompt),
                           torch.from_numpy(lens), TCFG,
                           tdecode.DecodeConfig(**tdcfg), n_new).numpy()
    return ref, out


def test_greedy_generate_matches_reference_and_full_forward(params):
    prompt = _prompt(1, 2, 8)
    lens = np.array([8, 8], np.int32)
    ref, out = _both(params, prompt, lens, 6, max_len=64)
    np.testing.assert_array_equal(out, ref)
    # Teacher forcing through the port's own full forward agrees too.
    seq = torch.from_numpy(np.concatenate([prompt, out], axis=1))
    logits = tllama.forward(params[1], seq, TCFG)
    np.testing.assert_array_equal(
        logits[:, 7:13].argmax(-1).numpy(), out)


def test_ragged_prompt_lengths_match_reference(params):
    prompt = _prompt(2, 3, 8)
    prompt[1, 5:] = 0
    lens = np.array([8, 5, 3], np.int32)
    ref, out = _both(params, prompt, lens, 5, max_len=32)
    np.testing.assert_array_equal(out, ref)


def test_eos_masking_matches_reference(params):
    prompt = _prompt(5, 3, 8)
    lens = np.array([8, 5, 3], np.int32)
    probe, _ = _both(params, prompt, lens, 8, max_len=32)
    eos = int(probe[0, 1])
    assert eos != int(probe[0, 0])
    ref, out = _both(params, prompt, lens, 8, max_len=32, eos_id=eos)
    np.testing.assert_array_equal(out, ref)
    counts = tdecode.completed_token_counts(out, eos)
    assert counts[0] == 2
    np.testing.assert_array_equal(
        counts, jdecode.completed_token_counts(ref, eos))
    for b in range(3):
        assert (out[b, counts[b]:] == eos).all()


def test_int8_kv_eos_and_ragged_match_reference(params):
    prompt = _prompt(6, 2, 8)
    prompt[1] = prompt[0]
    lens = np.array([8, 5], np.int32)
    kw = dict(max_len=32, kv_cache_dtype='int8', decode_attention='xla')
    probe, _ = _both(params, prompt, lens, 6, **kw)
    eos = int(probe[0, 1])
    ref, out = _both(params, prompt, lens, 6, eos_id=eos, **kw)
    np.testing.assert_array_equal(out, ref)
    assert tdecode.completed_token_counts(out, eos)[0] == 2


def test_sampled_decode_is_finite_and_in_range(params):
    gen = torch.Generator()
    gen.manual_seed(7)
    out = tdecode.generate(params[1], torch.from_numpy(_prompt(4, 2, 4)),
                           torch.tensor([4, 4]), TCFG,
                           tdecode.DecodeConfig(max_len=32,
                                                temperature=0.8), 8,
                           generator=gen)
    assert out.shape == (2, 8)
    assert ((out >= 0) & (out < TCFG.vocab_size)).all()


def test_sample_is_multinomials_draw():
    """The sampled draw (probabilities over Exp(1) noise, the form a CUDA
    graph can hold) is ``torch.multinomial``'s, bit for bit, and leaves
    the generator in the same state."""
    logits = torch.randn((7, 1000), generator=torch.Generator().manual_seed(1))
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    for temperature in (0.5, 0.8, 1.3):
        probs = torch.softmax(logits * 3 / temperature, dim=-1)
        for _ in range(4):
            want = torch.multinomial(probs, 1, generator=g1)[:, 0]
            got = tdecode.sample(logits * 3, g2, temperature)
            assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_generate_over_budget_raises_value_error(params):
    with pytest.raises(ValueError, match='exceeds max_len'):
        tdecode.generate(params[1], torch.from_numpy(_prompt(5, 1, 8)),
                         torch.tensor([8]), TCFG,
                         tdecode.DecodeConfig(max_len=16), 9)


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_paged_prefill_and_prefix_prefill_match_reference(params, kv):
    """paged_prefill, then paged_prefill_with_prefix over the written
    prefix (suffix-only forward), then one paged decode step: logits
    within BF16_ATOL of the reference, the same pool bytes written."""
    jp, tp = params
    bk, n_blocks = 8, 12
    full = _prompt(9, 1, 29)[0]
    m, p = 16, 29                         # prefix 2 blocks, suffix 13
    jpool = jdecode.init_block_pool(JCFG, n_blocks, bk, kv)
    tpool = tdecode.init_block_pool(TCFG, n_blocks, bk, kv)
    row = np.array([5, 2], np.int32)      # prefix blocks, shuffled
    pad = np.zeros((1, 16), np.int32)
    pad[0, :m] = full[:m]
    jl, jpool = jdecode.paged_prefill(jp, jnp.asarray(pad), jnp.int32(m),
                                      jnp.asarray(row), JCFG, jpool)
    tl = tdecode.paged_prefill(tp, torch.from_numpy(pad), m,
                               torch.from_numpy(row), TCFG, tpool)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_ATOL)
    suf = np.zeros((1, 16), np.int32)
    suf[0, :p - m] = full[m:]
    pref = np.array([5, 2], np.int32)
    srow = np.array([7, 3, 0], np.int32)  # positions 16.. → blocks 7, 3
    jl, jpool = jdecode.paged_prefill_with_prefix(
        jp, jnp.asarray(suf), jnp.int32(p - m), jnp.int32(m),
        jnp.asarray(pref), jnp.asarray(srow), JCFG, jpool)
    tl = tdecode.paged_prefill_with_prefix(
        tp, torch.from_numpy(suf), p - m, m, torch.from_numpy(pref),
        torch.from_numpy(srow), TCFG, tpool)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_ATOL)
    # The real positions' K/V landed in the same blocks on both sides.
    for blk in (5, 2, 7):
        ref = np.asarray(jpool['k'][:, blk]).astype(np.float32)
        got = tpool['k'][:, blk].float().numpy()
        tol = BF16_ATOL
        if kv == 'int8':
            # Compare dequantised values: a one-ulp bf16 difference in K
            # may move a code (and the row's scale) by a step or two.
            jscale = np.asarray(jpool['k_scale'][:, blk])[..., None]
            ref = ref * jscale
            got = got * tpool['k_scale'][:, blk].numpy()[..., None]
            tol = 2 * jscale + BF16_ATOL
        assert (np.abs(got - ref) <= tol).all()
    tables = np.array([[5, 2, 7, 3]], np.int32)
    tok, pos = np.array([int(full[-1])], np.int32), np.array([p], np.int32)
    jl, _ = jdecode._paged_decode_step(  # pylint: disable=protected-access
        jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(tables), JCFG,
        jdecode.DecodeConfig(max_len=32, decode_attention='xla',
                             kv_cache_dtype=kv, kernel_block_k=bk), jpool)
    tl = tdecode.paged_decode_step(
        tp, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(tables), TCFG,
        tdecode.DecodeConfig(max_len=32, kv_cache_dtype=kv,
                             kernel_block_k=bk), tpool)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_ATOL)
    # copy_block clones every plane of a block.
    tdecode.copy_block(tpool, 7, 9)
    for name in tpool:
        assert torch.equal(tpool[name][:, 9], tpool[name][:, 7])


def _int8_pool_prefill(tp, prompt, p, row):
    tpool = tdecode.init_block_pool(TCFG, 8, 8, 'int8')
    tdecode.paged_prefill(tp, torch.from_numpy(prompt), p,
                          torch.from_numpy(row), TCFG, tpool)
    return {name: t.numpy() for name, t in tpool.items()}


INT8_POOL_PROMPT = _prompt(5, 1, 32)
INT8_POOL_ROW = np.array([3, 1, 6, 2], np.int32)


def test_int8_paged_prefill_pool_matches_jitted_reference(params):
    """The int8 pool the port's paged prefill writes against the one the
    reference's jitted ``paged_prefill`` writes from the same prompt:
    layer 0 (same inputs on both sides) bit for bit, values and both
    scale planes; every layer's dequantised K/V within the bound
    test_paged_prefill_and_prefix_prefill_match_reference holds them
    to (later layers' inputs differ by XLA's excess precision; the
    subprocess test below turns it off)."""
    jp, tp = params
    got = _int8_pool_prefill(tp, INT8_POOL_PROMPT, 29, INT8_POOL_ROW)
    jpool = jdecode.init_block_pool(JCFG, 8, 8, 'int8')
    _, jpool = jdecode.paged_prefill(
        jp, jnp.asarray(INT8_POOL_PROMPT), jnp.int32(29),
        jnp.asarray(INT8_POOL_ROW), JCFG, jpool)
    ref = {name: np.asarray(a) for name, a in jpool.items()}
    assert set(got) == set(ref) == {'k', 'v', 'k_scale', 'v_scale'}
    for name in got:
        np.testing.assert_array_equal(got[name][0].view(np.uint8),
                                      ref[name][0].view(np.uint8))
    for name in ('k', 'v'):
        scale = ref[f'{name}_scale'][..., None]
        deq_ref = ref[name].astype(np.float32) * scale
        deq = got[name].astype(np.float32) * got[f'{name}_scale'][..., None]
        assert (np.abs(deq - deq_ref) <= 2 * scale + BF16_ATOL).all()


# The reference's int8 pool after one paged prefill, compiled with XLA's
# excess precision off, written to an .npz (a fresh process: XLA reads
# its flags once).
_INT8_NO_EXCESS_PRECISION = """
import sys
import jax, jax.numpy as jnp, numpy as np
from skypilot_tpu.models import decode, llama
cfg = llama.CONFIGS['debug']
params = llama.init_params(jax.random.PRNGKey(0), cfg)
prompt, row = np.load(sys.argv[1]), np.load(sys.argv[2])
pool = decode.init_block_pool(cfg, 8, 8, 'int8')
_, pool = decode.paged_prefill(params, jnp.asarray(prompt), jnp.int32(29),
                               jnp.asarray(row), cfg, pool)
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in pool.items()})
"""


def test_int8_pool_bit_equal_to_reference_without_excess_precision(
        params, tmp_path):
    """With ``--xla_allow_excess_precision=false`` the reference's jitted
    paged prefill writes the port's int8 pool bit for bit at every
    layer: values and both scale planes."""
    _, tp = params
    np.save(tmp_path / 'prompt.npy', INT8_POOL_PROMPT)
    np.save(tmp_path / 'row.npy', INT8_POOL_ROW)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # No persistent compile cache in the child: it is not hardened
    # against a kill mid-write as the suite's own processes are.
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', PYTHONPATH=root,
               JAX_ENABLE_COMPILATION_CACHE='false',
               XLA_FLAGS='--xla_allow_excess_precision=false')
    out = subprocess.run(
        [sys.executable, '-c', _INT8_NO_EXCESS_PRECISION,
         str(tmp_path / 'prompt.npy'), str(tmp_path / 'row.npy'),
         str(tmp_path / 'ref.npz')],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = np.load(tmp_path / 'ref.npz')
    got = _int8_pool_prefill(tp, INT8_POOL_PROMPT, 29, INT8_POOL_ROW)
    assert set(got) == set(ref.files)
    for name in got:
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      ref[name].view(np.uint8))
