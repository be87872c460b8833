"""Port chunked prefill (skypilot_tpu_torch/models/engine.py
``_advance_prefill`` / ``_finish_prefill``) against the JAX reference on
the ``debug`` config, with the reference's weights bridged through
numpy. Mirrors the chunked cases of tests/unit_tests/test_spec_decode.py.

* Greedy tokens of the chunked port engine equal the reference's static
  ``generate`` and the reference's own chunked ``DecodeEngine`` on the
  same request sequence (bf16 and int8 K/V; chunk 8, block-aligned at
  block_k 8, and chunk 12, whose chunks straddle block edges), with the
  same ``chunked_admissions`` and ``prefill_chunks``.
* After the last chunk the slot's table row and its live K/V in the
  pool equal the reference's: fp32 within 1e-5; bf16 bit for bit what
  the unchunked prefill writes, and within the bound of
  tests/test_torch_decode.py of the reference.
* Spec + chunked equals static ``generate``; chunking is paged-only and
  defaults from ``SKYTPU_PREFILL_CHUNK``; the ``spec_stats`` block.
* The bf16 prefill K/V equal, bit for bit at every layer, the
  reference's compiled with XLA's excess precision off (its default
  keeps the attention residual in fp32 into the FFN's RMSNorm).

Prompts and seeds are the reference test's own (tie-free on this model).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']
MAX_NEWS = [4, 8, 3, 6, 8]
FP32_KV_ATOL = 1e-5
BF16_ATOL = 1.6e-2        # tests/test_torch_decode.py


def _bridge(jp, cfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg)


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, _bridge(jp, CFG)


def _mixed_prompts(seed=3, prefix_len=16, extras=(3, 7, 0, 5, 9)):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG.vocab_size, size=prefix_len).tolist()
    return [shared + rng.randint(0, CFG.vocab_size, size=int(e)).tolist()
            for e in extras]


def _static(jparams, prompts, max_new, **dcfg):
    s = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lens = jnp.asarray([len(p) for p in prompts], jnp.int32)
    return np.asarray(jdecode.generate(
        jparams, jnp.asarray(batch), lens, JCFG,
        jdecode.DecodeConfig(decode_attention='xla', **dcfg), max_new))


def _dcfg(kv_dtype='bf16', spec_k=0, drafter_layers=1):
    return dict(max_len=64, kv_cache_dtype=kv_dtype, kernel_block_k=8,
                spec_k=spec_k, spec_drafter_layers=drafter_layers)


def _engine(tparams, dcfg, prefill_chunk=0, cfg=CFG):
    return engine_lib.DecodeEngine(tparams, cfg, tdecode.DecodeConfig(**dcfg),
                                   2, step_chunk=2,
                                   prefill_buckets=(16, 32), paged=True,
                                   num_blocks=40,
                                   prefill_chunk=prefill_chunk)


def _jengine(jparams, dcfg, prefill_chunk, cfg=JCFG):
    return jengine.DecodeEngine(
        jparams, cfg, jdecode.DecodeConfig(decode_attention='xla', **dcfg),
        2, step_chunk=2, prefill_buckets=(16, 32), paged=True,
        num_blocks=40, prefill_chunk=prefill_chunk, name='t-torch-chunk')


def _drain(eng, reqs, max_steps=500):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, 'engine did not converge'


@pytest.mark.parametrize('chunk', [8, 12])
@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_chunked_engine_matches_static_and_reference_engine(params, kv_dtype,
                                                            chunk):
    """Chunked on == static generate == the reference's chunked engine,
    token for token, with the same chunk counts; the step profiler saw
    the chunks."""
    jp, tp = params
    prompts = _mixed_prompts()
    static = _static(jp, prompts, 8, **_dcfg(kv_dtype))
    eng = _engine(tp, _dcfg(kv_dtype), prefill_chunk=chunk)
    reqs = [engine_lib.Request(p, m) for p, m in zip(prompts, MAX_NEWS)]
    _drain(eng, reqs)
    jeng = _jengine(jp, _dcfg(kv_dtype), chunk)
    jreqs = [jengine.Request(p, m) for p, m in zip(prompts, MAX_NEWS)]
    _drain(jeng, jreqs)
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert r.tokens == static[i, :MAX_NEWS[i]].tolist(), i
        assert r.tokens == jr.tokens, i
    stats, jstats = eng.stats(), jeng.stats()
    assert stats['chunked_admissions'] > 0
    assert stats['prefill_chunks'] >= 2 * stats['chunked_admissions']
    for key in ('chunked_admissions', 'prefill_chunks',
                'prefill_tokens_saved', 'admitted', 'evicted'):
        assert stats[key] == jstats[key], key
    recent = eng.profiler.snapshot(last_n=500)['recent']
    assert any(r['prefill_tokens'] > 0 for r in recent)
    assert eng.profiler.steps_recorded() == len(
        jeng.profiler.snapshot(last_n=500)['recent'])


def _admit_chunked(eng, mod, first, prompt):
    """Insert ``first`` then ``prompt``, run the latter's chunks to the
    end; returns (its table row, {plane: K/V at its positions [L, p,
    ...] as float32})."""
    eng.insert(mod.Request(first, 4))
    slot = eng.insert(mod.Request(prompt, 4))
    while eng._prefill_state[slot] is not None:  # pylint: disable=protected-access
        eng._advance_prefill()  # pylint: disable=protected-access
    row = np.array(eng._block_table_np[slot])  # pylint: disable=protected-access
    bk = eng._block_k  # pylint: disable=protected-access
    kv = {}
    for name, pool in eng._cache.items():  # pylint: disable=protected-access
        pool = (pool.float().numpy() if isinstance(pool, torch.Tensor)
                else np.asarray(pool).astype(np.float32))
        kv[name] = np.stack([pool[:, row[i // bk], i % bk]
                             for i in range(len(prompt))], axis=1)
    return row, kv


@pytest.mark.parametrize('chunk', [8, 12])
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_pool_after_last_chunk_matches_reference(params, dtype, chunk):
    """One 29-token prompt admitted chunked, behind an unchunked 7-token
    one whose two blocks it does not share: after its last chunk the
    slot's table row and the K/V at its 29 positions equal the
    reference's. fp32 within 1e-5. bf16: bit for bit what the port's
    unchunked prefill writes (chunking is invisible in the pool, as in
    the reference), layer 0 bit for bit the reference's, later layers
    within BF16_ATOL of it, the bound tests/test_torch_decode.py holds
    the unchunked prefill to. Layer 1 differs by up to 2e-3, chunked or
    not, because XLA's default excess precision feeds the reference's
    FFN RMSNorm the attention residual unrounded, where its source (and
    the port) rounds it to bf16: see
    test_bf16_kv_bit_equal_to_reference_without_excess_precision."""
    jp, tp = params
    jcfg, cfg = JCFG, CFG
    if dtype == 'fp32':
        jcfg = dataclasses.replace(JCFG, dtype=jnp.float32)
        cfg = dataclasses.replace(CFG, dtype=torch.float32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = _bridge(jp, cfg)
    rng = np.random.RandomState(5)
    first = rng.randint(0, CFG.vocab_size, size=7).tolist()
    prompt = rng.randint(0, CFG.vocab_size, size=29).tolist()
    eng = _engine(tp, _dcfg(), prefill_chunk=chunk, cfg=cfg)
    row, got = _admit_chunked(eng, engine_lib, first, prompt)
    assert eng.stats()['prefill_chunks'] == -(-29 // chunk)
    jrow, ref = _admit_chunked(_jengine(jp, _dcfg(), chunk, cfg=jcfg),
                               jengine, first, prompt)
    np.testing.assert_array_equal(row, jrow)
    for name in ('k', 'v'):
        if dtype == 'fp32':
            np.testing.assert_allclose(got[name], ref[name],
                                       atol=FP32_KV_ATOL, rtol=0)
            continue
        _, whole = _admit_chunked(_engine(tp, _dcfg()), engine_lib, first,
                                  prompt)
        np.testing.assert_array_equal(got[name], whole[name])
        np.testing.assert_array_equal(got[name][0], ref[name][0])
        np.testing.assert_allclose(got[name], ref[name], atol=BF16_ATOL,
                                   rtol=0)


def test_lone_long_prompt_prefills_every_chunk_in_one_step(params):
    """With no lane decoding there is nothing to hold up: one step runs
    every chunk and then decodes, as the reference does."""
    jp, tp = params
    prompt = np.random.RandomState(7).randint(0, CFG.vocab_size,
                                              size=30).tolist()
    eng = _engine(tp, _dcfg(), prefill_chunk=8)
    req = engine_lib.Request(prompt, 5)
    eng.submit(req)
    eng.step()
    assert eng.stats()['prefill_chunks'] == 4
    assert eng.stats()['decode_steps'] == 2 and len(req.tokens) == 3
    while not req.done:
        eng.step()
    assert req.tokens == _static(jp, [prompt], 5, **_dcfg())[0].tolist()


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_spec_plus_chunked_matches_static_generate(params, kv_dtype):
    jp, tp = params
    prompts = _mixed_prompts()
    static = _static(jp, prompts, 8, **_dcfg(kv_dtype))
    eng = _engine(tp, _dcfg(kv_dtype, spec_k=4), prefill_chunk=8)
    reqs = [engine_lib.Request(p, m) for p, m in zip(prompts, MAX_NEWS)]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :MAX_NEWS[i]].tolist(), i
    stats = eng.stats()
    assert stats['chunked_admissions'] > 0 and stats['spec_drafted'] > 0


def test_prefill_chunk_is_paged_only_and_env_defaultable(params,
                                                        monkeypatch):
    _, tp = params
    monkeypatch.setenv(engine_lib.PREFILL_CHUNK_ENV, '8')
    dense = engine_lib.DecodeEngine(tp, CFG, tdecode.DecodeConfig(max_len=64),
                                    1, prefill_buckets=(16,))
    assert dense.prefill_chunk == 0
    paged = engine_lib.DecodeEngine(
        tp, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=8), 1,
        prefill_buckets=(16,), paged=True, num_blocks=20)
    assert paged.prefill_chunk == 8
    assert _engine(tp, _dcfg(), prefill_chunk=12).prefill_chunk == 12
    monkeypatch.setenv(engine_lib.PREFILL_CHUNK_ENV, 'lots')
    assert _engine(tp, _dcfg(), prefill_chunk=None).prefill_chunk == 0


def test_spec_stats_block_shape(params):
    _, tp = params
    eng = _engine(tp, _dcfg(spec_k=2), prefill_chunk=8)
    block = eng.spec_stats()
    assert block['enabled'] and block['spec_k'] == 2
    assert block['prefill_chunk'] == 8
    for key in ('drafted_total', 'accepted_total', 'accept_ratio',
                'prefill_chunks_total', 'chunked_admissions',
                'drafter_layers'):
        assert key in block
    assert eng.stats()['prefill_chunk'] == 8
    assert _engine(tp, _dcfg()).spec_stats()['enabled'] is False


# The reference's prefill K/V of one prompt, compiled with XLA's excess
# precision off, written to an .npz (run in a fresh process: XLA reads
# its flags once).
_NO_EXCESS_PRECISION = """
import sys
import jax, jax.numpy as jnp, numpy as np
from skypilot_tpu.models import decode, llama
cfg = llama.CONFIGS['debug']
params = llama.init_params(jax.random.PRNGKey(0), cfg)
prompt = np.load(sys.argv[1])
cache = decode.init_kv_cache(cfg, 1, 32)
_, cache = decode.prefill(params, jnp.asarray(prompt), cfg, cache,
                          jnp.asarray([prompt.shape[1]], jnp.int32))
np.savez(sys.argv[2], k=np.asarray(cache['k']).view(np.uint16),
         v=np.asarray(cache['v']).view(np.uint16))
"""


def test_bf16_kv_bit_equal_to_reference_without_excess_precision(
        params, tmp_path):
    """Where the bf16 K/V after layer 0 differ from the reference's: XLA
    compiles with ``xla_allow_excess_precision`` on by default, which
    drops the bf16 rounding of ``x + attn @ wo`` before the FFN's
    RMSNorm inside the reference's jitted prefill. With it off, the
    reference's K/V equal the port's bit for bit at every layer; with
    it on, layer 1 differs (the test above, within BF16_ATOL)."""
    jp, tp = params
    prompt = np.random.RandomState(5).randint(
        0, CFG.vocab_size, size=(1, 29)).astype(np.int32)
    np.save(tmp_path / 'prompt.npy', prompt)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # No persistent compile cache in the child: it is not hardened
    # against a kill mid-write as the suite's own processes are.
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', PYTHONPATH=root,
               JAX_ENABLE_COMPILATION_CACHE='false',
               XLA_FLAGS='--xla_allow_excess_precision=false')
    out = subprocess.run(
        [sys.executable, '-c', _NO_EXCESS_PRECISION,
         str(tmp_path / 'prompt.npy'), str(tmp_path / 'ref.npz')],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = np.load(tmp_path / 'ref.npz')
    cache = tdecode.init_kv_cache(CFG, 1, 32)
    tdecode.prefill(tp, torch.from_numpy(prompt), CFG, cache,
                    torch.tensor([29]))
    for name in ('k', 'v'):
        got = cache[name].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, ref[name])
    # With the default flags (this process) layer 1 is not bit-equal.
    jcache = jdecode.init_kv_cache(JCFG, 1, 32)
    _, jcache = jdecode.prefill(jp, jnp.asarray(prompt), JCFG, jcache,
                                jnp.asarray([29], jnp.int32))
    assert not np.array_equal(np.asarray(jcache['k'][1]).view(np.uint16),
                              ref['k'][1])
