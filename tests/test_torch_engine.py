"""Port engine (skypilot_tpu_torch/models/engine.py) against the JAX
reference's static ``decode.generate`` on the ``debug`` config, bf16,
with the reference's weights bridged through numpy.

The load-bearing property is token-for-token equality: slot scheduling
(per-request prefill into a shared cache or block pool, mixed per-slot
positions, evict + refill, radix prefix sharing) must be invisible in
greedy output. Mirrors tests/unit_tests/test_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


def _prompts(n=5, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size,
                        size=int(rng.randint(3, 10))).tolist()
            for _ in range(n)]


def _static(jparams, prompts, max_new, **dcfg):
    """The reference's static batched generate over right-padded rows."""
    s = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lens = jnp.asarray([len(p) for p in prompts], jnp.int32)
    return np.asarray(jdecode.generate(jparams, jnp.asarray(batch), lens,
                                       JCFG, jdecode.DecodeConfig(**dcfg),
                                       max_new))


def _engine(tparams, num_slots=2, step_chunk=1, buckets=(16,), **dcfg):
    paged = dcfg.pop('paged', False)
    num_blocks = dcfg.pop('num_blocks', None)
    return engine_lib.DecodeEngine(tparams, CFG, tdecode.DecodeConfig(**dcfg),
                                   num_slots, step_chunk=step_chunk,
                                   prefill_buckets=buckets, paged=paged,
                                   num_blocks=num_blocks)


def _drain(eng, reqs, max_steps=500, submit=True):
    if submit:
        for r in reqs:
            eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, 'engine did not converge'


@pytest.mark.parametrize('step_chunk', [1, 4])
def test_greedy_engine_matches_static_generate(params, step_chunk):
    """5 requests through 2 slots: lanes evict and refill mid-run, and
    every request's tokens equal its reference static-batch row."""
    prompts = _prompts()
    max_news = [4, 8, 3, 6, 8]
    static = _static(params[0], prompts, 8, max_len=32)
    eng = _engine(params[1], step_chunk=step_chunk, max_len=32)
    reqs = [engine_lib.Request(p, m) for p, m in zip(prompts, max_news)]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :max_news[i]].tolist(), i
        assert r.finish_reason == 'length'
    stats = eng.stats()
    assert stats['admitted'] == stats['evicted'] == 5
    assert stats['active_slots'] == 0 and stats['queue_depth'] == 0
    assert 0.0 < stats['mean_occupancy'] <= 1.0


def test_engine_eos_matches_static_and_strips_padding(params):
    prompts = _prompts()
    probe = _static(params[0], prompts, 8, max_len=32)
    eos = int(probe[0, 1])
    static = _static(params[0], prompts, 8, max_len=32, eos_id=eos)
    counts = tdecode.completed_token_counts(static, eos)
    assert counts[0] == 2
    eng = _engine(params[1], step_chunk=3, max_len=32, eos_id=eos)
    reqs = [engine_lib.Request(p, 8) for p in prompts]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :counts[i]].tolist(), i
    assert reqs[0].finish_reason == 'eos'


def test_engine_int8_kv_matches_static_int8(params):
    prompts = _prompts(n=3, seed=7)
    static = _static(params[0], prompts, 5, max_len=32,
                     kv_cache_dtype='int8', decode_attention='xla')
    eng = _engine(params[1], step_chunk=2, max_len=32,
                  kv_cache_dtype='int8', decode_attention='plain')
    reqs = [engine_lib.Request(p, 5) for p in prompts]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i].tolist(), i


def test_insert_validation_and_one_token_requests(params):
    eng = _engine(params[1], num_slots=1, max_len=32)
    r = engine_lib.Request([5, 6, 7], 1)
    eng.insert(r)
    assert r.done and len(r.tokens) == 1 and r.finish_reason == 'length'
    assert eng.free_slots() == 1 and eng.stats()['decode_steps'] == 0
    eng.insert(engine_lib.Request([1, 2, 3], 4))
    with pytest.raises(RuntimeError):
        eng.insert(engine_lib.Request([1, 2, 3], 4))
    with pytest.raises(ValueError):
        _engine(params[1], num_slots=1, max_len=32).insert(
            engine_lib.Request([1] * 16, 20))
    with pytest.raises(ValueError):
        engine_lib.Request([], 4)
    with pytest.raises(ValueError):
        engine_lib.Request([1], 0)


def test_streaming_callback_order_and_done_flag(params):
    eng = _engine(params[1], num_slots=1, max_len=32)
    seen = []
    r = engine_lib.Request([3, 1, 4], 4,
                           on_token=lambda t, d: seen.append((t, d)))
    _drain(eng, [r])
    assert [t for t, _ in seen] == r.tokens
    assert [d for _, d in seen] == [False, False, False, True]


# ------------------------------------------------------------- paged mode


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_paged_engine_matches_static_generate(params, kv_dtype):
    """Paged pool + radix sharing is invisible in greedy output, through
    evict/refill and shared-prefix admissions."""
    rng = np.random.RandomState(3)
    shared = rng.randint(0, CFG.vocab_size, size=16).tolist()
    prompts = [shared + rng.randint(0, CFG.vocab_size,
                                    size=int(e)).tolist()
               for e in (3, 7, 0, 5, 9)]
    max_news = [4, 8, 3, 6, 8]
    static = _static(params[0], prompts, 8, max_len=64,
                     kv_cache_dtype=kv_dtype, decode_attention='xla')
    eng = _engine(params[1], step_chunk=2, buckets=(16, 32), max_len=64,
                  kv_cache_dtype=kv_dtype, kernel_block_k=8, paged=True,
                  num_blocks=40)
    reqs = [engine_lib.Request(p, m) for p, m in zip(prompts, max_news)]
    _drain(eng, reqs)
    for i, r in enumerate(reqs):
        assert r.tokens == static[i, :max_news[i]].tolist(), i
    stats = eng.stats()
    assert stats['paged'] and stats['prefill_tokens_saved'] > 0
    assert stats['active_slots'] == 0 and stats['queue_depth'] == 0


def test_paged_prefix_sharing_128_token_prefix(params):
    """Two requests sharing a 128-token prefix name the SAME pool blocks
    for it, and the second prefills only its suffix."""
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, CFG.vocab_size, size=128).tolist()
    p1 = prefix + rng.randint(0, CFG.vocab_size, size=5).tolist()
    p2 = prefix + rng.randint(0, CFG.vocab_size, size=9).tolist()
    eng = _engine(params[1], buckets=(16, 64, 160), max_len=192,
                  kernel_block_k=16, paged=True, num_blocks=64)
    r1, r2 = engine_lib.Request(p1, 3), engine_lib.Request(p2, 3)
    s1 = eng.insert(r1)
    assert eng.stats()['prefill_tokens_saved'] == 0
    s2 = eng.insert(r2)
    t1 = eng._block_table_np[s1, :8].tolist()  # pylint: disable=protected-access
    t2 = eng._block_table_np[s2, :8].tolist()  # pylint: disable=protected-access
    assert t1 == t2 and len(set(t1)) == 8
    assert eng._block_table_np[s1, 8] != eng._block_table_np[s2, 8]  # pylint: disable=protected-access
    stats = eng.stats()
    assert stats['prefill_tokens_saved'] == 128
    assert stats['prefix_hit_ratio'] > 0 and stats['blocks_used'] > 0
    static = _static(params[0], [p1, p2], 3, max_len=192)
    _drain(eng, [r1, r2], submit=False)
    assert r1.tokens == static[0].tolist()
    assert r2.tokens == static[1].tolist()


def test_paged_full_prompt_hit_copies_the_boundary_block(params):
    """A prompt entirely cached snaps back one token and rewrites it into
    a copy-on-write clone; output still equals the reference."""
    prompt = np.random.RandomState(12).randint(
        0, CFG.vocab_size, size=16).tolist()
    eng = _engine(params[1], buckets=(16,), max_len=32, kernel_block_k=8,
                  paged=True, num_blocks=12)
    r1, r2 = engine_lib.Request(prompt, 4), engine_lib.Request(prompt, 4)
    _drain(eng, [r1])
    _drain(eng, [r2])
    static = _static(params[0], [prompt], 4, max_len=32)
    assert r1.tokens == r2.tokens == static[0].tolist()
    assert eng.stats()['prefill_tokens_saved'] == 15


def test_paged_pool_exhaustion_queues_instead_of_failing(params):
    # 5 usable blocks; each request reserves ceil((16+8)/8) = 3.
    eng = _engine(params[1], max_len=64, kernel_block_k=8, paged=True,
                  num_blocks=6)
    reqs = [engine_lib.Request([i + 1] * 16, 8) for i in range(3)]
    _drain(eng, reqs)
    assert all(r.finish_reason == 'length' for r in reqs)
    assert all(len(r.tokens) == 8 for r in reqs)
    assert eng.stats()['blocks_used'] <= 5


def test_paged_blocked_request_is_not_starved_by_small_ones(params):
    # 6 usable blocks: big needs ceil((16+24)/8) = 5, smalls need 2.
    eng = _engine(params[1], max_len=64, kernel_block_k=8, paged=True,
                  num_blocks=7)
    finished = []

    def mk(prompt, max_new, tenant):
        r = engine_lib.Request(prompt, max_new, tenant=tenant)
        r.on_token = (lambda rr: lambda t, d:
                      finished.append(rr.id) if d else None)(r)
        return r

    first_small = mk([1] * 9, 7, 'small')
    big = mk([2] * 16, 24, 'big')
    later = [mk([i + 3] * 9, 7, 'small') for i in range(3)]
    _drain(eng, [first_small, big] + later)
    assert finished.index(big.id) == 1, finished


def test_paged_admission_failure_releases_reservation(params):
    eng = _engine(params[1], max_len=64, kernel_block_k=8, paged=True,
                  num_blocks=10)
    bad = engine_lib.Request([1] * 40, 4)   # fits the pool, no bucket
    good = engine_lib.Request([2] * 10, 3)
    _drain(eng, [bad, good])
    assert bad.finish_reason.startswith('rejected'), bad.finish_reason
    assert good.finish_reason == 'length' and len(good.tokens) == 3
    assert eng._allocator.available() == \
        9 - eng._radix.held_blocks()  # pylint: disable=protected-access


def test_engine_clamps_and_rejects_over_budget_admissions(params):
    eng = _engine(params[1], num_slots=1, max_len=32)
    ok = engine_lib.Request([1, 2, 3], 4)
    clamped = engine_lib.Request([5] * 10, 500)
    rejected = engine_lib.Request([7] * 32, 4)
    _drain(eng, [ok, clamped, rejected])
    assert ok.finish_reason == 'length' and len(ok.tokens) == 4
    assert len(clamped.tokens) == 22 and clamped.finish_reason == 'length'
    assert rejected.finish_reason.startswith('rejected')
    assert rejected.tokens == []
    assert eng.stats()['rejected'] == 1


def test_tenant_round_robin_and_fifo_admission(params):
    eng = _engine(params[1], num_slots=1, max_len=32)
    finished = []

    def mk(tag):
        r = engine_lib.Request([3, 1, 4], 2, tenant=tag)
        r.on_token = (lambda rr: lambda t, d:
                      finished.append((rr.tenant, rr.id)) if d else None)(r)
        return r

    burst = [mk('noisy') for _ in range(4)]
    quiet = mk('quiet')
    for r in burst + [quiet]:
        eng.submit(r)
    _drain(eng, burst + [quiet], submit=False)
    assert [t for t, _ in finished].index('quiet') == 1, finished
    noisy = [rid for t, rid in finished if t == 'noisy']
    assert noisy == [r.id for r in burst]      # FIFO within a tenant
