"""Port speculative decoding (skypilot_tpu_torch: ``ops/decode_attention``
verify twin, ``models/decode`` drafter and verify step, the engine's
spec round) against the JAX reference on the ``debug`` config, with the
reference's weights bridged through numpy. Mirrors
tests/unit_tests/test_spec_decode.py (its chunked-prefill and telemetry
cases belong to later slices of the port).

* The verify twin equals the reference's ``paged_verify_attention_xla``
  and its Pallas kernel (interpret mode) in fp32 at 2e-5 and int8 at
  1e-4 (the constants of tests/test_torch_decode_attention.py); with one
  query it is the paged decode twin bit for bit.
* The drafter gives the reference's drafts; the verify step's logits are
  within BF16_ATOL (tests/test_torch_decode.py) and it writes the same
  pool entries, positions past ``max_len`` going to scratch block 0.
* The spec engine's greedy tokens equal the reference's static
  ``generate`` (bf16 and int8 KV); a rejection rolls ``pos`` back and
  leaves the committed pool bytes equal to a non-spec engine's.

Seeds are the reference test's own (tie-free on this model).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import decode_attention as jda
from skypilot_tpu.ops import quant as jquant
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']
ATOL = RTOL = 2e-5
INT8_ATOL = INT8_RTOL = 1e-4
BF16_ATOL = 1.6e-2


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------ verify twin


def _verify_case(seed, b=3, s=4, h=8, hkv=2, hd=32, block_k=16, n_bt=4):
    """q [B,S,H,hd] fp32 and a shuffled fp32 pool [n, block_k, Hkv, hd]
    with tables [B, n_bt]; rows 0 and 2 share their first block."""
    rng = np.random.RandomState(seed)
    n_blocks = b * n_bt + 2
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(n_blocks, block_k, hkv, hd).astype(np.float32)
    v = rng.randn(n_blocks, block_k, hkv, hd).astype(np.float32)
    tables = (rng.permutation(b * n_bt) + 2).reshape(b, n_bt)
    tables[2, 0] = tables[0, 0]
    return q, k, v, tables.astype(np.int32)


# Starts at block boundaries (15, 16, 31, 32 with block_k 16) and near
# the end: max_len is 64, so start 62 + S 4 drafts past it.
@pytest.mark.parametrize('starts', [(0, 15, 16), (31, 32, 47), (62, 60, 1)])
def test_verify_plain_matches_reference(starts):
    q, k, v, bt = _verify_case(0)
    start = np.array(starts, np.int32)
    out = tda.paged_verify_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bt, start)))
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, start)]
    _close(out, jda.paged_verify_attention_xla(*jargs))
    _close(out, jda.paged_verify_attention_kernel(*jargs, interpret=True))


def test_verify_plain_int8_matches_reference():
    q, k, v, bt = _verify_case(1, s=5)
    start = np.array([13, 62, 40], np.int32)
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(v)))
    arrays = (q, kq, vq, bt, start, ks, vs)
    out = tda.paged_verify_attention_plain(
        *(torch.from_numpy(a) for a in arrays))
    jargs = [jnp.asarray(a) for a in arrays]
    _close(out, jda.paged_verify_attention_xla(*jargs), INT8_ATOL,
           INT8_RTOL)
    _close(out, jda.paged_verify_attention_kernel(*jargs, interpret=True),
           INT8_ATOL, INT8_RTOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_verify_plain_one_query_is_the_decode_twin(dtype):
    """S = 1 verify at start == paged decode at cur_len = start + 1, bit
    for bit (what pins spec output to the non-spec path)."""
    q, k, v, bt = _verify_case(2, s=1)
    start = torch.tensor([0, 16, 63])
    tq, tk, tv, tbt = (torch.from_numpy(a) for a in (q, k, v, bt))
    tq, tk, tv = tq.to(dtype), tk.to(dtype), tv.to(dtype)
    got = tda.paged_verify_attention_plain(tq, tk, tv, tbt, start)
    want = tda.paged_decode_attention_plain(tq, tk, tv, tbt, start + 1)
    assert torch.equal(got, want)


def test_verify_dispatch_and_wrapper_never_fall_back():
    q, k, v, bt = _verify_case(3)
    args = [torch.from_numpy(a) for a in (q, k, v, bt)]
    start = torch.tensor([3, 20, 40])
    before = tda.paged_verify_attention_kernel.launches
    out = tda.paged_verify_attention(*args, start)
    assert torch.equal(out, tda.paged_verify_attention_plain(*args, start))
    assert tda.paged_verify_attention_kernel.launches == before
    with pytest.raises(ValueError, match='CUDA'):
        tda.paged_verify_attention_kernel(*args, start)


# --------------------------------------------------- drafter and verify


def _random_pool(seed, kv, n_blocks, block_k):
    """The same random pool on both sides: bf16 values (or int8 codes +
    fp32 scales) → (torch pool, jax pool)."""
    rng = np.random.RandomState(seed)
    shape = (CFG.n_layers, n_blocks, block_k, CFG.n_kv_heads, CFG.head_dim)
    tpool = {}
    for name in ('k', 'v'):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        if kv == 'int8':
            tpool[name] = torch.from_numpy(
                rng.randint(-127, 128, shape).astype(np.int8))
            tpool[f'{name}_scale'] = torch.from_numpy(
                rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32))
        else:
            tpool[name] = x.bfloat16()
    jpool = {}
    for name, t in tpool.items():
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        jpool[name] = jnp.asarray(a).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else a.dtype)
    return tpool, jpool


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_drafter_and_verify_step_match_reference(params, kv):
    jp, tp = params
    bk, n_blocks, k_spec = 8, 14, 3
    tpool, jpool = _random_pool(4, kv, n_blocks, bk)
    # max_len 32 (4 blocks); lane 1 sits at 30, so its verify positions
    # 32 and 33 lie past max_len and must land in scratch block 0.
    tables = np.array([[3, 7, 5, 9], [2, 11, 4, 13]], np.int32)
    token = np.array([17, 201], np.int32)
    pos = np.array([12, 30], np.int32)
    dcfg = dict(max_len=32, kv_cache_dtype=kv, kernel_block_k=bk,
                spec_k=k_spec, spec_drafter_layers=1)
    jdcfg = jdecode.DecodeConfig(decode_attention='xla', **dcfg)
    tdcfg = tdecode.DecodeConfig(**dcfg)
    jdrafts = np.asarray(jdecode._spec_draft_tokens(  # pylint: disable=protected-access
        jp, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(tables),
        JCFG, jdcfg, jpool))
    before = {n: t.clone() for n, t in tpool.items()}
    tdrafts = tdecode.spec_draft_tokens(
        tp, torch.from_numpy(token), torch.from_numpy(pos),
        torch.from_numpy(tables), CFG, tdcfg, tpool)
    np.testing.assert_array_equal(tdrafts.numpy(), jdrafts)
    for name, t in tpool.items():         # the drafter never writes
        assert torch.equal(t, before[name])

    seq = np.concatenate([token[:, None], jdrafts], axis=1)
    jl, jpool = jdecode._paged_verify_step(  # pylint: disable=protected-access
        jp, jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(tables), JCFG,
        jdcfg, jpool)
    tl = tdecode.paged_verify_step(
        tp, torch.from_numpy(seq), torch.from_numpy(pos),
        torch.from_numpy(tables), CFG, tdcfg, tpool)
    assert tl.shape == (2, k_spec + 1, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_ATOL)
    # The same pool entries changed on both sides: positions 12-15 of
    # lane 0 (block 7), 30-31 of lane 1 (block 13), and 32-33 of lane 1
    # routed to scratch block 0 (offsets 7, as the reference clamps);
    # no other block moved. Layer 0, whose input is the embedding on
    # both sides, writes the same K/V bytes (int8: the same codes).
    # Later layers as in tests/test_torch_decode.py: a one-ulp bf16
    # difference in a layer's input may move K/V by an ulp (an int8 code
    # by a step or two).
    def changed(pool, old):
        return np.asarray(pool != old).any(axis=(-1, -2))  # [L, n, bk]

    for name in ('k', 'v'):
        got, ref = tpool[name].float().numpy(), np.asarray(
            jpool[name]).astype(np.float32)
        old = before[name].float().numpy()
        mask = changed(got, old)
        np.testing.assert_array_equal(mask, changed(ref, old))
        assert set(np.argwhere(mask)[:, 1].tolist()) == {0, 7, 13}
        np.testing.assert_array_equal(got[0], ref[0])
        tol = BF16_ATOL
        if kv == 'int8':
            jscale = np.asarray(jpool[f'{name}_scale'])[..., None]
            ref = ref * jscale
            got = got * tpool[f'{name}_scale'].numpy()[..., None]
            tol = 2 * jscale + BF16_ATOL
        assert (np.abs(got - ref) <= tol).all(), name


# ----------------------------------------------------------------- engine


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


def _dcfg(kv_dtype='bf16', spec_k=0, drafter_layers=1, **kw):
    return tdecode.DecodeConfig(max_len=64, kv_cache_dtype=kv_dtype,
                                kernel_block_k=8, spec_k=spec_k,
                                spec_drafter_layers=drafter_layers, **kw)


def _engine(tparams, dcfg, num_slots=2, chunk=2):
    return engine_lib.DecodeEngine(tparams, CFG, dcfg, num_slots,
                                   step_chunk=chunk,
                                   prefill_buckets=(16, 32), paged=True,
                                   num_blocks=40)


def _drain(eng, reqs, max_steps=500):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, 'engine did not converge'
    return steps


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_spec_engine_matches_static_generate(params, kv_dtype):
    """Greedy spec on == static generate, token for token, through
    mid-run evict/refill, shared prefixes, and mid-draft rejections."""
    jp, tp = params
    prompts = _mixed_prompts()
    max_news = [4, 8, 3, 6, 8]
    static = _static(jp, prompts, 8, max_len=64, kv_cache_dtype=kv_dtype,
                     kernel_block_k=8)
    eng = _engine(tp, _dcfg(kv_dtype, spec_k=3))
    reqs = [engine_lib.Request(p, m) for p, m in zip(prompts, max_news)]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :max_news[i]].tolist(), i
    stats = eng.stats()
    assert stats['spec_drafted'] > 0
    # The one-layer drafter mis-predicts on the random-init model:
    # rejections happened, so the rollback path ran.
    assert stats['spec_accepted'] < stats['spec_drafted']
    assert 0.0 <= stats['spec_accept_ratio'] <= 1.0
    assert stats['prefill_tokens_saved'] > 0     # the shared prefix


def test_spec_with_full_depth_drafter_accepts_nearly_everything(params):
    jp, tp = params
    prompts = _mixed_prompts(seed=2)
    static = _static(jp, prompts, 8, max_len=64, kernel_block_k=8)
    eng = _engine(tp, _dcfg(spec_k=3, drafter_layers=CFG.n_layers))
    reqs = [engine_lib.Request(p, 8) for p in prompts]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i].tolist(), i
    assert eng.stats()['spec_accept_ratio'] > 0.8


def _committed_kv(eng, slot, upto):
    bk = eng._block_k  # pylint: disable=protected-access
    tab = eng._block_table_np[slot]  # pylint: disable=protected-access
    return [torch.stack([eng._cache[name][:, tab[i // bk], i % bk]  # pylint: disable=protected-access
                         for i in range(upto)], dim=1)
            for name in ('k', 'v')]


def test_rollback_mid_draft_restores_pos_and_cache_exactly(params):
    """After one spec round with a rejection: pos advanced by exactly the
    delivered count, and the pool's K/V at every committed position is
    byte-identical to a non-speculative engine fed the same request."""
    _, tp = params
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, CFG.vocab_size, size=13).tolist()
    eng_s = _engine(tp, _dcfg(spec_k=4), chunk=1)
    eng_b = _engine(tp, _dcfg(), chunk=1)
    r_s = engine_lib.Request(prompt, 12)
    r_b = engine_lib.Request(prompt, 12)
    slot_s = eng_s.insert(r_s)
    slot_b = eng_b.insert(r_b)
    eng_s.step()                          # one draft + verify round
    stats = eng_s.stats()
    assert stats['spec_drafted'] == 4 and stats['decode_steps'] == 1
    assert stats['spec_accepted'] < 4, 'no rejection: rollback untested'
    emitted = len(r_s.tokens) - 1         # minus the prefill's first
    assert 1 <= emitted == stats['spec_accepted'] + 1
    assert eng_s._pos[slot_s] == len(prompt) + emitted  # pylint: disable=protected-access
    while len(r_b.tokens) < len(r_s.tokens):
        eng_b.step()
    assert r_b.tokens[:len(r_s.tokens)] == r_s.tokens
    assert eng_b._pos[slot_b] == eng_s._pos[slot_s]  # pylint: disable=protected-access
    upto = len(prompt) + emitted  # the last token's K/V is not yet written
    for a, b in zip(_committed_kv(eng_s, slot_s, upto),
                    _committed_kv(eng_b, slot_b, upto)):
        assert torch.equal(a, b)


def test_spec_respects_budget_and_eos(params):
    """A draft run longer than the remaining budget is clipped, and an
    accepted EOS ends the request mid-run."""
    jp, tp = params
    prompts = _mixed_prompts(seed=4)
    probe = _static(jp, prompts, 8, max_len=64, kernel_block_k=8)
    eos = int(probe[0, 1])
    static = _static(jp, prompts, 8, max_len=64, kernel_block_k=8,
                     eos_id=eos)
    counts = tdecode.completed_token_counts(static, eos)
    assert counts[0] == 2                 # the early stop fires
    eng = _engine(tp, _dcfg(spec_k=4, eos_id=eos))
    reqs = [engine_lib.Request(p, 8) for p in prompts]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :counts[i]].tolist(), i
        assert len(r.tokens) <= 8
    assert reqs[0].finish_reason == 'eos'


def test_spec_requires_paged_and_greedy(params):
    _, tp = params
    with pytest.raises(ValueError, match='paged'):
        engine_lib.DecodeEngine(tp, CFG, _dcfg(spec_k=2), 1,
                                prefill_buckets=(16,))
    hot = dataclasses.replace(_dcfg(spec_k=2), temperature=0.7)
    with pytest.raises(ValueError, match='greedy'):
        engine_lib.DecodeEngine(tp, CFG, hot, 1, prefill_buckets=(16,),
                                paged=True)
    for depth in (0, CFG.n_layers + 1):
        deep = dataclasses.replace(_dcfg(spec_k=2),
                                   spec_drafter_layers=depth)
        with pytest.raises(ValueError, match='drafter'):
            engine_lib.DecodeEngine(tp, CFG, deep, 1,
                                    prefill_buckets=(16,), paged=True)


def test_spec_stats_block_shape(params):
    _, tp = params
    eng = _engine(tp, _dcfg(spec_k=2))
    block = eng.spec_stats()
    assert block['enabled'] and block['spec_k'] == 2
    assert block['drafter_layers'] == 1
    for key in ('drafted_total', 'accepted_total', 'accept_ratio'):
        assert block[key] == 0
    assert eng.stats()['spec_k'] == 2
    off = _engine(tp, _dcfg())
    assert off.spec_stats()['enabled'] is False
    assert 'spec_k' not in off.stats()
