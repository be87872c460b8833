"""Port durable block store (skypilot_tpu_torch/models/block_store.py, the
paged engine's store fetch and write-behind spill, the model server's
store role, ``GET/POST /prefix_blocks`` on a store and ``/prewarm``) on
the ``debug`` config, block_k 8, with the reference's weights bridged
through numpy.

* Parity with the JAX package, bf16 and int8 K/V: a JAX engine spills
  through the reference's store into a directory, a port store opened on
  that directory warms a port engine, whose greedy tokens equal the JAX
  engine's own and a port control's; and the other way round. The family
  and entry digests are the reference's; a directory written by either
  package loads in the other with the same ``stats()``. In a subprocess
  with XLA's excess precision off, the int8 entries the two packages
  write for one prompt are the same file byte for byte, and the bf16
  entries' blocks are bit-equal in layer 0 and at most one value one bf16
  ulp off after it (ROADMAP, queue 3, kept on purpose).
* The reference's ``tests/unit_tests/test_block_store.py`` cases against
  the port (all but the tensor-parallel one and the autoscaler's digest
  demand, which the port has not): store-warmed parity with the owner's
  blocks bit for bit, store-down and raising-transport backoff, mismatch
  without backoff, dtype skew, spill-failure backoff, a torn entry read
  as a miss, the tmp sweep, survival across a restart, capacity eviction
  of the coldest family, the longest of a prefix chain, a prewarm round
  trip, ``handle_store_post`` never answering 500, ``store_slow``; and
  the outcomes the reference has no case for: a store URL that is this
  replica, pool exhaustion, the spill queue's dedupe and bound, the
  transports against a stub store.
* HTTP: an owner replica with ``store_url`` spills to a ``--role store``
  server over ``SKYTPU_STORE_DIR``; a fresh replica's ``/generate`` is
  answered over the store's blocks; ``/prewarm`` warms a third; the
  counters, ``/slo`` blocks and journal rows; the endpoints' refusals.

Tolerances: tokens identical; blocks of the port's own round trips
``torch.equal``. ``cuda`` cases (the store round trip on the card through
the paged-decode kernel) run there: ``python -m pytest --noconftest -m
cuda tests/test_torch_block_store.py``. The reference is imported inside
fixtures, so the card, which has no jax, collects this file.
"""
import ast
import http.server
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import block_store, convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import prefix_transfer
from skypilot_tpu_torch.observability import journal, metrics
from skypilot_tpu_torch.ops import decode_attention as da
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.utils import chaos

torch.set_num_threads(2)

CFG = tllama.CONFIGS['debug']
BLOCK_K = 8
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def ref():
    """The JAX reference and the bridged params (imported here, not at
    module import)."""
    import jax
    from skypilot_tpu.models import block_store as jstore
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import engine as jengine
    from skypilot_tpu.models import llama as jllama
    from skypilot_tpu.models import prefix_transfer as jtransfer
    from skypilot_tpu.observability import metrics as jmetrics
    jcfg = jllama.CONFIGS['debug']
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return types.SimpleNamespace(
        store=jstore, decode=jdecode, engine=jengine, transfer=jtransfer,
        metrics=jmetrics, cfg=jcfg, params=jparams,
        port_params=convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), CFG))


@pytest.fixture
def params(ref):
    return ref.port_params


@pytest.fixture(autouse=True)
def fresh_registry():
    prev = metrics.set_registry(metrics.MetricsRegistry())
    yield
    metrics.set_registry(prev)


@pytest.fixture
def jregistry(ref):
    prev = ref.metrics.set_registry(ref.metrics.MetricsRegistry())
    yield
    ref.metrics.set_registry(prev)


@pytest.fixture
def jdb(tmp_path):
    return str(tmp_path / 'journal.db')


def _engine(params, kv='bf16', **kwargs):
    return engine_lib.DecodeEngine(
        params, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=BLOCK_K,
                                          kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, **kwargs)


def _jengine(ref, kv='bf16', **kwargs):
    return ref.engine.DecodeEngine(
        ref.params, ref.cfg, ref.decode.DecodeConfig(
            max_len=64, temperature=0.0, decode_attention='xla',
            kernel_block_k=BLOCK_K, kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, name='t-torch-store', **kwargs)


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while not all(r.done for r in reqs):
        eng.step()


def _shared_prefix(seed=3, n=24):
    # The reference test's tie-free seed.
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=n).tolist()


def _store_fetch(store, handle=block_store.handle_store_post,
                 decode=prefix_transfer.decode_payload):
    """A fetch transport through the whole wire format of the store role:
    ``handle`` (either package's dispatch) over ``store``, a JSON round
    trip, ``decode``."""

    def fetch(url, tokens, from_tokens, budget):
        del url, budget
        status, reply = handle(store, {'prompt': [int(t) for t in tokens],
                                       'from_tokens': int(from_tokens)})
        assert status == 200
        return decode(json.loads(json.dumps(reply)))

    return fetch


def _store_spill(store, handle=block_store.handle_store_post,
                 encode=prefix_transfer.encode_payload):
    """A spill transport: ``encode`` the engine's host export as
    ``http_store_spill`` does, a JSON round trip, the store's dispatch."""

    def spill(url, tokens, raw, budget):
        del url, budget
        body = encode(raw['matched_tokens'], raw['from_tokens'],
                      raw['block_k'], raw['kv_cache_dtype'], raw['arrays'])
        body['prompt'] = [int(t) for t in tokens]
        status, reply = handle(store, json.loads(json.dumps(body)))
        return status == 200 and bool(reply.get('ok'))

    return spill


def _no_spill(url, tokens, raw, budget):
    """A benign spill for tests of the fetch path: the default transport
    would POST to the fake URL, fail, and back the store off."""
    return True


def _pump_spills(eng, store, want=1):
    """Step the loop until the write-behind spill lands and is
    harvested."""
    for _ in range(400):
        eng.step()
        if store.stats()['spills'] >= want:
            eng.step()
            return
        time.sleep(0.005)
    raise AssertionError(f'spill never landed: {store.stats()}')


def _export_run(eng, tokens):
    raw = eng._export_prefix_now(list(tokens), 0)  # pylint: disable=protected-access
    assert raw is not None
    return raw


def _rows(eng, kind):
    eng.flush_journal()
    return [e['payload'] for e in journal.query(kinds=[kind],
                                                db_path=eng.journal_db)]


# ------------------------------------------------------- across packages


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_jax_spill_warms_port_engine(ref, params, kv, tmp_path, jregistry,
                                     jdb):
    """A JAX replica's write-behind spill, through the reference's store,
    lands in a directory; the port's store opened on that directory warms
    a port replica, whose greedy tokens equal the JAX replica's local
    prefill and a port control's."""
    shared = _shared_prefix()
    root = str(tmp_path / 'store')
    jstore = ref.store.BlockStore(root)
    jowner = _jengine(ref, kv, store_url='store://fleet',
                      store_fetch_fn=_store_fetch(
                          jstore, ref.store.handle_store_post,
                          ref.transfer.decode_payload),
                      store_spill_fn=_store_spill(
                          jstore, ref.store.handle_store_post,
                          ref.transfer.encode_payload),
                      journal_db=str(tmp_path / 'jax.db'))
    _drive(jowner, [ref.engine.Request(shared + [1, 2, 3], 6)])
    _pump_spills(jowner, jstore)
    assert jstore.stats()['entries'] == 1
    store = block_store.BlockStore(root)
    assert store.stats()['entries'] == 1
    prompt = shared + [5, 6, 7, 8]
    fetcher = _engine(params, kv, store_url='store://fleet',
                      store_fetch_fn=_store_fetch(store),
                      store_spill_fn=_no_spill, journal_db=jdb)
    control = _engine(params, kv)
    rf, rc = engine_lib.Request(prompt, 8), engine_lib.Request(prompt, 8)
    _drive(fetcher, [rf])
    _drive(control, [rc])
    jr = ref.engine.Request(prompt, 8)
    _drive(_jengine(ref, kv, journal_db=str(tmp_path / 'jax.db')), [jr])
    assert rf.tokens == rc.tokens == jr.tokens
    cache = fetcher.cache_stats()
    assert cache['store_fetch_hits'] == 1
    assert cache['store_fetch_tokens'] == len(shared)


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_port_spill_warms_jax_engine(ref, params, kv, tmp_path, jregistry,
                                     jdb):
    """The other way round: a port replica's spill through the port's
    store; the reference's store opened on that directory warms a JAX
    replica to its own local-prefill tokens and the port's."""
    shared = _shared_prefix()
    root = str(tmp_path / 'store')
    store = block_store.BlockStore(root)
    owner = _engine(params, kv, store_url='store://fleet',
                    store_fetch_fn=_store_fetch(store),
                    store_spill_fn=_store_spill(store), journal_db=jdb)
    _drive(owner, [engine_lib.Request(shared + [1, 2, 3], 6)])
    _pump_spills(owner, store)
    jstore = ref.store.BlockStore(root)
    assert jstore.stats()['entries'] == 1
    prompt = shared + [4, 3, 2, 1]
    jfetcher = _jengine(ref, kv, store_url='store://fleet',
                        store_fetch_fn=_store_fetch(
                            jstore, ref.store.handle_store_post,
                            ref.transfer.decode_payload),
                        store_spill_fn=_no_spill,
                        journal_db=str(tmp_path / 'jax.db'))
    jr = ref.engine.Request(prompt, 8)
    _drive(jfetcher, [jr])
    assert jfetcher.cache_stats()['store_fetch_hits'] == 1
    assert jfetcher.cache_stats()['store_fetch_tokens'] == len(shared)
    jc = ref.engine.Request(prompt, 8)
    _drive(_jengine(ref, kv, journal_db=str(tmp_path / 'jax.db')), [jc])
    rc = engine_lib.Request(prompt, 8)
    _drive(owner, [rc])
    assert jr.tokens == jc.tokens == rc.tokens


@pytest.mark.parametrize('seed,family_tokens', [(0, 128), (1, 16), (2, 1),
                                                (3, None)])
def test_digests_are_the_reference_digests(ref, seed, family_tokens):
    rng = np.random.RandomState(seed)
    for n in (1, 7, 16, 129, 300):
        tokens = rng.randint(0, 128_256, size=n).tolist()
        assert block_store.family_digest(tokens, family_tokens) == \
            ref.store.family_digest(tokens, family_tokens)
        assert block_store._entry_digest(tokens) == \
            ref.store._entry_digest(tokens)  # pylint: disable=protected-access
        # numpy integers read as their values.
        assert block_store._entry_digest(np.asarray(tokens)) == \
            ref.store._entry_digest(tokens)  # pylint: disable=protected-access


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_store_directory_loads_in_the_other_package(ref, params, writer,
                                                    tmp_path, jregistry):
    """Entries of two families (bf16 and int8) and a prefix chain written
    by one package load in the other with the same ``stats()`` as a
    reload in the writer's own, and serve the same bytes."""
    runs = [(_shared_prefix(3, 32), 'bf16'), (_shared_prefix(5, 24), 'int8')]
    root = str(tmp_path / 'store')
    if writer == 'jax':
        wstore = ref.store.BlockStore(root)
        for run, kv in runs:
            eng = _jengine(ref, kv, journal_db=str(tmp_path / 'jax.db'))
            _drive(eng, [ref.engine.Request(run + [1], 2)])
            assert wstore.put(run, _export_run(eng, run))
            assert wstore.put(run[:16], _export_run(eng, run[:16]))
    else:
        wstore = block_store.BlockStore(root)
        for run, kv in runs:
            eng = _engine(params, kv)
            _drive(eng, [engine_lib.Request(run + [1], 2)])
            assert wstore.put(run, _export_run(eng, run))
            assert wstore.put(run[:16], _export_run(eng, run[:16]))
    theirs = block_store.BlockStore(root)
    mine = ref.store.BlockStore(root)
    want = mine.stats() if writer == 'jax' else theirs.stats()
    assert theirs.stats() == mine.stats() == want
    # Runs shorter than the family window are families of their own.
    assert want['entries'] == 4 and want['families'] == 4
    assert sorted(theirs.families()) == sorted(mine.families())
    for run, _ in runs:
        got = theirs.get(run, 8, block_k=BLOCK_K)
        ref_got = mine.get(run, 8, block_k=BLOCK_K)
        assert got['matched_tokens'] == ref_got['matched_tokens'] == len(run)
        for name, t in got['arrays'].items():
            a = ref_got['arrays'][name]
            assert tuple(t.shape) == a.shape
            carrier = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
            assert t.contiguous().view(carrier).numpy().tobytes() == \
                np.ascontiguousarray(a).tobytes(), name


# The reference's entries for one prompt, written by its engine's spill
# into its store with XLA's excess precision off (a fresh process: XLA
# reads its flags once); prints the reloaded store's stats.
_NO_EXCESS_PRECISION = """
import json, sys
import jax
from skypilot_tpu.models import block_store, decode, engine, llama
cfg = llama.CONFIGS['debug']
params = llama.init_params(jax.random.PRNGKey(0), cfg)
prompt = json.loads(sys.argv[1])
for kv in ('bf16', 'int8'):
    store = block_store.BlockStore(sys.argv[2] + '/' + kv)
    eng = engine.DecodeEngine(
        params, cfg, decode.DecodeConfig(max_len=64, decode_attention='xla',
                                         kernel_block_k=8,
                                         kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, journal_db=sys.argv[2] + '/j.db')
    req = engine.Request(prompt, 2)
    eng.submit(req)
    while not req.done:
        eng.step()
    assert store.put(prompt[:24], eng._export_prefix_now(prompt[:24], 0))
print(json.dumps({kv: block_store.BlockStore(sys.argv[2] + '/' + kv).stats()
                  for kv in ('bf16', 'int8')}))
"""


def test_cross_package_entries_without_excess_precision(params, tmp_path):
    """With XLA's excess precision off, the int8 entry the reference
    writes for a prompt is the port's file byte for byte, and the bf16
    entry's blocks are the port's bit for bit in layer 0 and at most one
    value one bf16 ulp off later (the K/V projections' fp32 accumulation
    order, as ``tests/test_torch_prefix_fetch.py`` holds the fetched
    blocks). The reference's directory loads in the port with the stats
    the reference reports."""
    prompt = _shared_prefix() + [1, 2, 3]
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', PYTHONPATH=REPO_ROOT,
               JAX_ENABLE_COMPILATION_CACHE='false',
               XLA_FLAGS='--xla_allow_excess_precision=false')
    out = subprocess.run(
        [sys.executable, '-c', _NO_EXCESS_PRECISION, json.dumps(prompt),
         str(tmp_path / 'ref')],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref_stats = json.loads(out.stdout.strip().splitlines()[-1])
    flips = 0
    for kv in ('bf16', 'int8'):
        theirs = block_store.BlockStore(str(tmp_path / 'ref' / kv))
        assert theirs.stats() == ref_stats[kv]
        owner = _engine(params, kv)
        _drive(owner, [engine_lib.Request(prompt, 2)])
        mine = block_store.BlockStore(str(tmp_path / 'port' / kv))
        assert mine.put(prompt[:24], _export_run(owner, prompt[:24]))
        assert mine.stats() == {**ref_stats[kv], 'spills': 1}
        name = block_store._entry_digest(prompt[:24]) + '.json'  # pylint: disable=protected-access
        fam = block_store.family_digest(prompt[:24])
        with open(tmp_path / 'ref' / kv / fam / name, 'rb') as f:
            ref_bytes = f.read()
        with open(tmp_path / 'port' / kv / fam / name, 'rb') as f:
            port_bytes = f.read()
        if kv == 'int8':
            assert ref_bytes == port_bytes
            continue
        got = prefix_transfer.decode_payload(json.loads(ref_bytes))
        want = prefix_transfer.decode_payload(json.loads(port_bytes))
        assert len(ref_bytes) == len(port_bytes)
        for plane, t in want['arrays'].items():
            a = got['arrays'][plane].view(torch.int16).numpy().astype(
                np.int32)
            b = t.view(torch.int16).numpy().astype(np.int32)
            np.testing.assert_array_equal(a[0], b[0])
            assert (np.abs(a - b) <= 1).all(), plane
            flips += int((a != b).sum())
    assert flips <= 1, flips


# ----------------------------------------------- the reference's cases


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_store_warmed_parity(params, kv, tmp_path, jdb):
    """After a full fleet restart a replica warmed only from the store
    gives a cold local prefill's tokens; its blocks are the owner's bit
    for bit; the hit and the spill are counted and journaled."""
    shared = _shared_prefix()
    store = block_store.BlockStore(str(tmp_path / 'store'))
    owner = _engine(params, kv, store_url='store://fleet',
                    store_fetch_fn=_store_fetch(store),
                    store_spill_fn=_store_spill(store), journal_db=jdb)
    _drive(owner, [engine_lib.Request(shared + [1, 2, 3], 6)])
    _pump_spills(owner, store)
    assert store.stats()['entries'] == 1
    assert owner.cache_stats()['store_spills'] == 1
    assert owner.cache_stats()['store_spill_tokens'] == len(shared)
    prompt = shared + [5, 6, 7, 8]
    fetcher = _engine(params, kv, store_url='store://fleet',
                      store_fetch_fn=_store_fetch(store),
                      store_spill_fn=_store_spill(store), journal_db=jdb)
    control = _engine(params, kv)
    rf, rc = engine_lib.Request(prompt, 8), engine_lib.Request(prompt, 8)
    _drive(fetcher, [rf])
    _drive(control, [rc])
    assert rf.tokens == rc.tokens
    cache = fetcher.cache_stats()
    assert cache['store_fetch_hits'] == 1 and cache['store_configured']
    assert cache['store_fetch_tokens'] == len(shared)
    assert cache['prefill_tokens_saved'] >= len(shared)
    assert fetcher.stats()['store_fetch_hits'] == 1
    got, want = _export_run(fetcher, shared), _export_run(owner, shared)
    assert set(got['arrays']) == set(owner._cache)  # pylint: disable=protected-access
    for name, t in want['arrays'].items():
        assert torch.equal(got['arrays'][name], t), name
    hits = [r for r in _rows(fetcher, journal.EventKind.ENGINE_STORE_FETCH)
            if r.get('outcome') == 'hit']
    assert len(hits) == 1 and hits[0]['tokens_gained'] == len(shared)
    assert hits[0]['blocks_gained'] == len(shared) // BLOCK_K
    assert hits[0]['store'] == 'store://fleet' and hits[0]['seconds'] >= 0
    # The owner's spill, and the fetcher's of the same run (a cheap
    # duplicate).
    spills = _rows(owner, journal.EventKind.STORE_SPILL)
    assert spills and {r['outcome'] for r in spills} == {'ok'}
    text = metrics.generate_latest().decode()
    assert 'skytpu_store_fetches_total{result="hit"} 1' in text
    assert 'skytpu_store_fetches_total{result="miss"} 1' in text
    assert 'skytpu_store_spills_total{result="ok"}' in text


def test_store_down_backs_off_and_degrades_to_prefill(params, jdb):
    """A dead store costs one admission a lookup and is backed off; every
    request is answered by plain prefill."""
    calls = []

    def down(url, tokens, from_tokens, budget):
        calls.append(list(tokens))

    eng = _engine(params, store_url='store://dead', store_fetch_fn=down,
                  store_spill_fn=_no_spill, journal_db=jdb)
    control = _engine(params)
    p1 = _shared_prefix(seed=7) + [1]
    p2 = _shared_prefix(seed=11) + [2]
    r1, r2 = engine_lib.Request(p1, 4), engine_lib.Request(p2, 4)
    c1, c2 = engine_lib.Request(p1, 4), engine_lib.Request(p2, 4)
    _drive(eng, [r1])
    _drive(eng, [r2])
    _drive(control, [c1])
    _drive(control, [c2])
    assert r1.tokens == c1.tokens and r2.tokens == c2.tokens
    assert len(calls) == 1
    assert eng.store_in_backoff()
    assert eng.cache_stats()['store_fetch_misses'] == 1
    assert eng.cache_stats()['store_in_backoff']
    assert [r['outcome'] for r in _rows(
        eng, journal.EventKind.ENGINE_STORE_FETCH)] == ['down']


def test_store_fetch_exception_backs_off(params, jdb):
    def boom(url, tokens, from_tokens, budget):
        raise RuntimeError('store exploded')

    eng = _engine(params, store_url='store://bad', store_fetch_fn=boom,
                  store_spill_fn=_no_spill, journal_db=jdb)
    control = _engine(params)
    prompt = _shared_prefix(seed=13) + [3]
    r, c = engine_lib.Request(prompt, 4), engine_lib.Request(prompt, 4)
    _drive(eng, [r])
    _drive(control, [c])
    assert r.tokens == c.tokens
    assert eng.store_in_backoff()
    rows = _rows(eng, journal.EventKind.ENGINE_STORE_FETCH)
    assert [r['outcome'] for r in rows] == ['error']
    assert 'store exploded' in rows[0]['error']
    text = metrics.generate_latest().decode()
    assert 'skytpu_store_fetches_total{result="error"} 1' in text


def test_store_mismatch_rejected_without_backoff(params, tmp_path, jdb):
    """A version-skewed entry (wrong block_k) fails the install's
    validation: plain prefill, correct tokens, and no backoff."""
    shared = _shared_prefix()
    store = block_store.BlockStore(str(tmp_path / 'store'))
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    assert store.put(shared, _export_run(owner, shared))
    inner = _store_fetch(store)

    def skewed(url, tokens, from_tokens, budget):
        payload = inner(url, tokens, from_tokens, budget)
        payload['block_k'] = 4
        return payload

    eng = _engine(params, store_url='store://skew', store_fetch_fn=skewed,
                  store_spill_fn=_no_spill, journal_db=jdb)
    control = _engine(params)
    prompt = shared + [5, 6]
    r, c = engine_lib.Request(prompt, 6), engine_lib.Request(prompt, 6)
    _drive(eng, [r])
    _drive(control, [c])
    assert r.tokens == c.tokens
    assert not eng.store_in_backoff()
    assert eng.cache_stats()['store_fetch_hits'] == 0
    assert [r['outcome'] for r in _rows(
        eng, journal.EventKind.ENGINE_STORE_FETCH)] == ['mismatch']


def test_store_dtype_skew_rejected(params, tmp_path):
    """A bf16 entry cannot warm an int8 engine: rejected at install."""
    shared = _shared_prefix()
    store = block_store.BlockStore(str(tmp_path / 'store'))
    owner = _engine(params, 'bf16')
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    assert store.put(shared, _export_run(owner, shared))
    eng = _engine(params, 'int8', store_url='store://skew',
                  store_fetch_fn=_store_fetch(store),
                  store_spill_fn=_no_spill)
    control = _engine(params, 'int8')
    prompt = shared + [5, 6]
    r, c = engine_lib.Request(prompt, 6), engine_lib.Request(prompt, 6)
    _drive(eng, [r])
    _drive(control, [c])
    assert r.tokens == c.tokens
    assert eng.cache_stats()['store_fetch_hits'] == 0


def test_spill_failure_backs_off_store(params, jdb):
    """A refused spill is counted, journaled and backs the store off for
    fetch and spill alike."""
    shared = _shared_prefix()
    refused = []

    def refuse(url, tokens, raw, budget):
        refused.append(len(tokens))
        return False

    eng = _engine(params, store_url='store://full',
                  store_fetch_fn=lambda *a: prefix_transfer.empty_payload(
                      0, BLOCK_K, 'bf16'),
                  store_spill_fn=refuse, journal_db=jdb)
    _drive(eng, [engine_lib.Request(shared + [1, 2, 3], 6)])
    for _ in range(400):
        eng.step()
        if eng.cache_stats()['store_spill_failures']:
            break
        time.sleep(0.005)
    cache = eng.cache_stats()
    assert cache['store_spill_failures'] == 1
    assert cache['store_spills'] == 0
    assert refused == [len(shared)]
    assert eng.store_in_backoff()
    assert [r['outcome'] for r in _rows(
        eng, journal.EventKind.STORE_SPILL)] == ['failed']
    text = metrics.generate_latest().decode()
    assert 'skytpu_store_spills_total{result="failed"} 1' in text


def test_torn_entry_is_a_miss_not_garbage(params, tmp_path, monkeypatch):
    """``store_torn_entry``: a spill that persists half an entry reads as
    a miss and is dropped on contact; at a restart it is swept."""
    shared = _shared_prefix()
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    raw = _export_run(owner, shared)
    root = str(tmp_path / 'store')
    store = block_store.BlockStore(root)
    monkeypatch.setenv('SKYTPU_CHAOS', 'store_torn_entry')
    chaos.reset()
    try:
        assert store.put(shared, raw)
    finally:
        monkeypatch.delenv('SKYTPU_CHAOS')
        chaos.reset()
    assert store.get(shared, 0, block_k=BLOCK_K) is None
    stats = store.stats()
    assert stats['torn_dropped'] == 1 and stats['entries'] == 0
    monkeypatch.setenv('SKYTPU_CHAOS', 'store_torn_entry')
    chaos.reset()
    try:
        assert store.put(shared, raw)
    finally:
        monkeypatch.delenv('SKYTPU_CHAOS')
        chaos.reset()
    reloaded = block_store.BlockStore(root)
    assert reloaded.stats()['entries'] == 0
    assert reloaded.stats()['torn_dropped'] == 1
    assert reloaded.get(shared, 0, block_k=BLOCK_K) is None


def test_interrupted_tmp_spill_swept_on_load(params, tmp_path):
    shared = _shared_prefix()
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    root = str(tmp_path / 'store')
    store = block_store.BlockStore(root)
    assert store.put(shared, _export_run(owner, shared))
    fam_dir = os.path.join(root, block_store.family_digest(shared))
    tmp = os.path.join(fam_dir, 'deadbeef.json.tmp-123-456')
    with open(tmp, 'wb') as f:
        f.write(b'{"half": ')
    reloaded = block_store.BlockStore(root)
    assert not os.path.exists(tmp)
    assert reloaded.stats()['entries'] == 1
    assert reloaded.get(shared, 0, block_k=BLOCK_K) is not None


def test_store_survives_restart(params, tmp_path):
    shared = _shared_prefix()
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    root = str(tmp_path / 'store')
    block_store.BlockStore(root).put(shared, _export_run(owner, shared))
    reloaded = block_store.BlockStore(root)
    eng = _engine(params, store_url='store://fleet',
                  store_fetch_fn=_store_fetch(reloaded),
                  store_spill_fn=_no_spill)
    control = _engine(params)
    prompt = shared + [5, 6]
    r, c = engine_lib.Request(prompt, 6), engine_lib.Request(prompt, 6)
    _drive(eng, [r])
    _drive(control, [c])
    assert r.tokens == c.tokens
    assert eng.cache_stats()['store_fetch_hits'] == 1


def test_capacity_evicts_coldest_family(params, tmp_path):
    """With room for two entries a third evicts the family touched longest
    ago, not the one just read; an entry alone over capacity stays."""
    runs = [_shared_prefix(seed=s) for s in (3, 5, 7)]
    owner = _engine(params)
    for run in runs:
        _drive(owner, [engine_lib.Request(run + [1], 4)])
    payloads = [_export_run(owner, run) for run in runs]
    probe = block_store.BlockStore(str(tmp_path / 'probe'))
    assert probe.put(runs[0], payloads[0])
    entry_bytes = probe.stats()['bytes']
    store = block_store.BlockStore(str(tmp_path / 'store'),
                                   capacity_bytes=int(entry_bytes * 2.5))
    assert store.put(runs[0], payloads[0])
    assert store.put(runs[1], payloads[1])
    assert store.get(runs[0], 0, block_k=BLOCK_K) is not None
    assert store.put(runs[2], payloads[2])
    stats = store.stats()
    assert stats['evictions'] == 1 and stats['entries'] == 2
    fams = set(store.families())
    assert block_store.family_digest(runs[0]) in fams
    assert block_store.family_digest(runs[2]) in fams
    assert block_store.family_digest(runs[1]) not in fams
    assert store.get(runs[1], 0, block_k=BLOCK_K) is None
    tiny = block_store.BlockStore(str(tmp_path / 'tiny'), capacity_bytes=1)
    assert tiny.put(runs[0], payloads[0])
    assert tiny.stats()['entries'] == 1 and tiny.stats()['evictions'] == 0


def test_prefix_chain_coexists_longest_wins(params, tmp_path):
    shared = _shared_prefix(n=32)
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    store = block_store.BlockStore(str(tmp_path / 'store'))
    assert store.put(shared[:16], _export_run(owner, shared[:16]))
    assert store.put(shared, _export_run(owner, shared))
    assert store.stats()['entries'] == 2
    got = store.get(shared, 16, block_k=BLOCK_K)
    assert got['from_tokens'] == 16 and got['matched_tokens'] == 32
    assert got['arrays']['k'].shape[1] == 2
    other_tail = shared[:16] + [7] * 16
    got = store.get(other_tail, 0, block_k=BLOCK_K)
    assert got is not None and got['matched_tokens'] == 16
    # Without block_k (the store role's handler) the family's stored
    # lengths are probed, longest first.
    assert store.get(shared, 0)['matched_tokens'] == 32
    assert store.get(shared, 32) is None


def test_prewarm_roundtrip_warms_cold_engine(params, tmp_path):
    """A family digest resolves to its longest run, which a cold engine
    takes through the handoff injection, so the family's first request
    prefills only its tail."""
    shared = _shared_prefix()
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    store = block_store.BlockStore(str(tmp_path / 'store'))
    assert store.put(shared, _export_run(owner, shared))
    status, body = block_store.handle_store_post(
        store, {'digest': block_store.family_digest(shared)})
    assert status == 200 and body.get('prompt') == list(shared)
    tokens = [int(t) for t in body['prompt']]
    payload = prefix_transfer.decode_payload(json.loads(json.dumps(body)))
    eng = _engine(params)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        res=eng.inject_handoff_blocks(tokens, payload)))
    t.start()
    while t.is_alive():
        eng.step()
        time.sleep(0.001)
    t.join(30)
    assert box['res']['ok'] and box['res']['gained'] == len(shared)
    control = _engine(params)
    prompt = shared + [5, 6]
    r, c = engine_lib.Request(prompt, 6), engine_lib.Request(prompt, 6)
    _drive(eng, [r])
    _drive(control, [c])
    assert r.tokens == c.tokens
    assert eng.cache_stats()['prefill_tokens_saved'] >= len(shared)
    # The entry digest resolves too.
    assert store.get_by_digest(block_store._entry_digest(shared))[0] == \
        list(shared)  # pylint: disable=protected-access


def test_handle_store_post_never_500s(tmp_path):
    store = block_store.BlockStore(str(tmp_path / 'store'))
    assert block_store.handle_store_post(store, 'nonsense')[0] == 400
    assert block_store.handle_store_post(store, {})[0] == 400
    assert block_store.handle_store_post(
        store, {'prompt': ['x', 'y']})[0] == 400
    assert block_store.handle_store_post(
        store, {'arrays': {}, 'prompt': [1, 2]})[0] == 400
    good = prefix_transfer.encode_payload(
        8, 0, 8, 'bf16', {'k': torch.ones(1, 1, 8, 2, 4,
                                          dtype=torch.bfloat16)})
    assert block_store.handle_store_post(
        store, {**good, 'prompt': ['x'] * 8})[0] == 400
    assert block_store.handle_store_post(
        store, {**good, 'prompt': [1] * 4}) == (200, {'ok': False})
    status, body = block_store.handle_store_post(
        store, {'prompt': [1, 2, 3], 'from_tokens': 0})
    assert status == 200
    assert prefix_transfer.decode_payload(body)['arrays'] == {}
    assert block_store.handle_store_post(
        store, {'digest': 'f' * 16}) == (200, {'ok': False})


def test_store_slow_chaos_delays_lookup(tmp_path, monkeypatch):
    store = block_store.BlockStore(str(tmp_path / 'store'))
    monkeypatch.setenv('SKYTPU_CHAOS', 'store_slow:1')
    monkeypatch.setenv('SKYTPU_CHAOS_STORE_SLOW_SECONDS', '0.05')
    chaos.reset()
    try:
        t0 = time.perf_counter()
        assert store.get([1] * 8, 0, block_k=BLOCK_K) is None
        assert time.perf_counter() - t0 >= 0.05
        t0 = time.perf_counter()
        store.get([1] * 8, 0, block_k=BLOCK_K)
        assert time.perf_counter() - t0 < 0.05
    finally:
        chaos.reset()
    monkeypatch.setenv('SKYTPU_CHAOS_STORE_SLOW_SECONDS', 'soon')
    assert chaos.store_slow_seconds() == block_store.DEFAULT_STORE_SLOW_SECONDS


# ------------------------------------------- outcomes the reference lacks


def test_store_url_addressing_this_replica_disables_the_tier(params, jdb):
    """A store that answers ``{"self": true}`` is this replica: the tier
    is switched off, the admission a miss, the tokens a prefill's."""
    calls = []

    def me(url, tokens, from_tokens, budget):
        calls.append(url)
        return {'self': True}

    eng = _engine(params, store_url='http://me:1', store_fetch_fn=me,
                  store_spill_fn=_no_spill, journal_db=jdb)
    control = _engine(params)
    prompt = _shared_prefix() + [1]
    r, c = engine_lib.Request(prompt, 4), engine_lib.Request(prompt, 4)
    _drive(eng, [r, engine_lib.Request(_shared_prefix(5) + [2], 2)])
    _drive(control, [c])
    assert r.tokens == c.tokens and calls == ['http://me:1']
    assert eng.store_url is None and not eng.store_in_backoff()
    assert not eng.cache_stats()['store_configured']
    assert [r['outcome'] for r in _rows(
        eng, journal.EventKind.ENGINE_STORE_FETCH)] == ['miss']


def test_store_fetch_pool_exhausted_degrades(params, tmp_path, jdb):
    """An entry the pool cannot hold (every block taken) is counted as
    ``pool_exhausted``; the store is not backed off."""
    shared = _shared_prefix()
    store = block_store.BlockStore(str(tmp_path / 'store'))
    owner = _engine(params)
    _drive(owner, [engine_lib.Request(shared + [1], 4)])
    assert store.put(shared, _export_run(owner, shared))
    eng = _engine(params, store_url='store://fleet',
                  store_fetch_fn=_store_fetch(store),
                  store_spill_fn=_no_spill, journal_db=jdb)
    taken = eng._allocator.alloc(eng._allocator.available())  # pylint: disable=protected-access
    req = engine_lib.Request(shared + [5], 4)
    assert not eng._store_fetch_into_cache(req, [], 0)  # pylint: disable=protected-access
    eng._allocator.decref(taken)  # pylint: disable=protected-access
    assert not eng.store_in_backoff()
    assert eng.cache_stats()['store_fetch_misses'] == 1
    assert [r['outcome'] for r in _rows(
        eng, journal.EventKind.ENGINE_STORE_FETCH)] == ['pool_exhausted']


def test_spill_queue_dedups_bounds_and_skips_short_runs(params, monkeypatch):
    """One spill per distinct run, the 16 newest kept (older ones dropped
    and counted), runs under the minimum never queued; the minimum reads
    ``SKYTPU_STORE_SPILL_MIN_TOKENS`` (0: one block)."""
    eng = _engine(params, store_url='store://fleet',
                  store_spill_fn=_no_spill)
    queue = eng._queue_store_spill  # pylint: disable=protected-access
    queue([1] * 4)
    queue([1] * 8)
    queue([1] * 8)
    for i in range(20):
        queue([i] * 16)
    pending = eng._spill_pending  # pylint: disable=protected-access
    assert len(pending) == 16 and pending[-1] == [19] * 16
    assert eng.cache_stats()['store_spill_drops'] == 5
    monkeypatch.setenv(block_store.SPILL_MIN_TOKENS_ENV, '24')
    eng = _engine(params, store_url='store://fleet',
                  store_spill_fn=_no_spill)
    eng._queue_store_spill([1] * 16)  # pylint: disable=protected-access
    eng._queue_store_spill([1] * 24)  # pylint: disable=protected-access
    assert eng._spill_pending == [[1] * 24]  # pylint: disable=protected-access
    dense = engine_lib.DecodeEngine(
        params, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=BLOCK_K),
        1, store_url='store://fleet')
    assert dense.store_url is None


class _StubStore(http.server.BaseHTTPRequestHandler):
    """POST /prefix_blocks: the server's ``mode`` decides the reply."""

    def log_message(self, *args):  # pylint: disable=arguments-differ
        pass

    def do_POST(self):  # pylint: disable=invalid-name
        body = json.loads(self.rfile.read(
            int(self.headers['Content-Length'])))
        self.server.seen.append((self.path, body))
        mode = self.server.mode
        if mode == '500':
            self.send_response(500)
            self.end_headers()
            return
        if mode == 'slow':
            time.sleep(0.5)
        if 'digest' in body:
            reply = prefix_transfer.encode_payload(
                8, 0, 8, 'bf16', {'k': torch.ones(1, 1, 8, 2, 4,
                                                  dtype=torch.bfloat16)})
            reply['prompt'] = list(range(8))
        else:
            reply = {'ok': mode != 'refuse'}
        data = json.dumps(reply).encode()
        self.send_response(200)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def stub_store():
    srv = http.server.ThreadingHTTPServer(('127.0.0.1', 0), _StubStore)
    srv.daemon_threads = True
    srv.seen, srv.mode = [], 'ok'
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, f'http://127.0.0.1:{srv.server_address[1]}/'
    srv.shutdown()
    srv.server_close()
    t.join(10)


def test_http_store_transports(stub_store, monkeypatch):
    """The spill POSTs the encoded run plus its prompt and is True only on
    an acknowledged persist; the pre-warm fetch returns (tokens, payload);
    a reply slower than half the budget, a non-200, a refusal and a dead
    port are failures; ``store_down`` fails all three before any bytes
    move."""
    srv, url = stub_store
    payload = {'matched_tokens': 8, 'from_tokens': 0, 'block_k': 8,
               'kv_cache_dtype': 'int8',
               'arrays': {'k': torch.arange(8, dtype=torch.int8).view(
                   1, 1, 8, 1, 1)}}
    assert block_store.http_store_spill(url, list(range(8)), payload, 5.0)
    path, body = srv.seen[-1]
    assert path == '/prefix_blocks' and body['prompt'] == list(range(8))
    assert prefix_transfer.decode_payload(body)['arrays']['k'].equal(
        payload['arrays']['k'])
    tokens, got = block_store.http_store_prewarm_fetch(url, 'abc', 5.0)
    assert tokens == list(range(8)) and got['matched_tokens'] == 8
    assert srv.seen[-1][1] == {'digest': 'abc'}
    srv.mode = 'refuse'
    assert not block_store.http_store_spill(url, [1] * 8, payload, 5.0)
    srv.mode = 'slow'
    t0 = time.monotonic()
    assert not block_store.http_store_spill(url, [1] * 8, payload, 0.2)
    assert block_store.http_store_prewarm_fetch(url, 'abc', 0.2) is None
    assert time.monotonic() - t0 < 1.0
    srv.mode = '500'
    assert not block_store.http_store_spill(url, [1] * 8, payload, 5.0)
    assert block_store.http_store_prewarm_fetch(url, 'abc', 5.0) is None
    srv.mode = 'ok'
    n = len(srv.seen)
    monkeypatch.setenv('SKYTPU_CHAOS', 'store_down')
    assert not block_store.http_store_spill(url, [1] * 8, payload, 5.0)
    assert block_store.http_store_prewarm_fetch(url, 'abc', 5.0) is None
    assert block_store.http_store_fetch(url, [1] * 8, 0, 5.0) is None
    assert len(srv.seen) == n
    monkeypatch.delenv('SKYTPU_CHAOS')
    srv.server_close()
    assert block_store.http_store_prewarm_fetch('store://x', 'a', 1) is None
    assert not block_store.http_store_spill('nowhere', [1] * 8, payload, 1)


def test_store_transports_use_no_requests():
    """The card host has no ``requests``: the store's and the wire
    format's modules import only the standard library, numpy, torch and
    the port."""
    for rel in ('skypilot_tpu_torch/models/block_store.py',
                'skypilot_tpu_torch/models/prefix_transfer.py'):
        with open(os.path.join(REPO_ROOT, rel), encoding='utf-8') as f:
            tree = ast.parse(f.read())
        mods = {alias.name.split('.')[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
        mods |= {node.module.split('.')[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
        assert 'requests' not in mods and 'aiohttp' not in mods, rel


# ------------------------------------------------------------------- http


def _http(url, path, body=None, raw=None, timeout=60):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'null')


def _wait(cond, what, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f'timed out: {what}'
        time.sleep(0.01)


def _replica(params, **kwargs):
    eng = model_server.build_engine('debug', 2, 64, paged=True,
                                    block_k=BLOCK_K, device='cpu',
                                    params=params,
                                    store_url=kwargs.pop('store_url', None))
    srv = model_server.ModelServer(eng, 0, host='127.0.0.1', **kwargs)
    return srv, eng, f'http://127.0.0.1:{srv.start()}'


def test_store_tier_over_http(params, tmp_path, monkeypatch):
    """An owner replica spills to a ``--role store`` server (its store
    opened from ``SKYTPU_STORE_DIR``); a fresh replica answers over the
    store's blocks with the owner's tokens; ``/prewarm`` warms a third,
    whose next request is a radix hit; counters, ``/slo`` and journal
    rows report it."""
    monkeypatch.setenv('SKYTPU_JOURNAL_PATH', str(tmp_path / 'j.db'))
    monkeypatch.setenv('SKYTPU_STORE_SPILL_BUDGET_SECONDS', '10')
    monkeypatch.setenv('SKYTPU_STORE_FETCH_BUDGET_SECONDS', '10')
    monkeypatch.setenv('SKYTPU_PREWARM_BUDGET_SECONDS', '10')
    shared = _shared_prefix()
    servers = []
    try:
        monkeypatch.setenv(block_store.STORE_DIR_ENV, str(tmp_path / 'dir'))
        store_srv, _, store_url = _replica(params, role='store')
        monkeypatch.delenv(block_store.STORE_DIR_ENV)
        servers.append(store_srv)
        assert store_srv.store is not None
        owner, owner_eng, url_a = _replica(params, store_url=store_url)
        servers.append(owner)
        body = {'prompt': shared + [1, 2, 3], 'max_new_tokens': 4,
                'stream': False}
        assert _http(url_a, '/generate', body)[0] == 200
        _wait(lambda: owner_eng.cache_stats()['store_spills'] == 1,
              'the owner spill')
        status, stats = _http(store_url, '/prefix_blocks')
        assert status == 200 and stats['entries'] == 1
        prompt = {'prompt': shared + [5, 6, 7, 8], 'max_new_tokens': 6,
                  'stream': False}
        _, want = _http(url_a, '/generate', prompt)
        fetcher, _, url_b = _replica(params, store_url=store_url)
        servers.append(fetcher)
        _, got = _http(url_b, '/generate', prompt)
        assert got['tokens'] == want['tokens']
        _, slo = _http(url_b, '/slo')
        assert slo['cache']['store_fetch_hits'] == 1
        assert slo['cache']['store_fetch_tokens'] == len(shared)
        assert slo['store']['configured_url'] == store_url
        assert slo['store']['hosting'] is False
        _, slo = _http(store_url, '/slo')
        assert slo['store']['hosting'] and slo['role'] == 'store'
        assert slo['store']['stats']['hits'] >= 1
        warm, warm_eng, url_c = _replica(params, store_url=store_url)
        servers.append(warm)
        status, reply = _http(url_c, '/prewarm', {
            'digests': [block_store.family_digest(shared), 'f' * 16]})
        assert status == 200
        assert reply == {'ok': True, 'warmed': 1, 'missed': 1,
                         'tokens': len(shared)}
        _, got = _http(url_c, '/generate', prompt)
        assert got['tokens'] == want['tokens']
        cache = warm_eng.cache_stats()
        assert cache['store_fetch_hits'] == cache['store_fetch_misses'] == 0
        assert cache['prefill_tokens_saved'] >= len(shared)
        _, slo = _http(url_c, '/slo')
        assert (slo['store']['prewarms'], slo['store']['prewarm_tokens']) \
            == (1, len(shared))
        text = metrics.generate_latest().decode()
        assert 'skytpu_store_fetches_total{result="hit"} 1' in text
        assert 'skytpu_store_spills_total{result="ok"}' in text
        assert 'skytpu_prewarm_requests_total 1' in text
        assert f'skytpu_prewarm_tokens_total {len(shared)}' in text
        for srv in servers:
            srv.engine.flush_journal()
        rows = journal.query(kinds=[journal.EventKind.AUTOSCALE_PREWARM])
        assert len(rows) == 1 and rows[0]['payload']['warmed'] == 1
        assert rows[0]['payload']['store'] == store_url
        assert journal.query(kinds=[journal.EventKind.STORE_SPILL])
        assert any(r['payload']['outcome'] == 'hit' for r in journal.query(
            kinds=[journal.EventKind.ENGINE_STORE_FETCH]))
    finally:
        for srv in servers:
            srv.stop()


def test_store_endpoints_refusals(params, tmp_path, monkeypatch):
    """``GET /prefix_blocks`` answers a store's stats and 404 without
    one; a store answers a malformed ``POST /prefix_blocks`` with 400;
    ``/prewarm`` answers 400 on an unpaged replica or a malformed body,
    404 without a configured store, and counts every digest the store
    cannot serve as missed (``store_down`` included)."""
    monkeypatch.setenv('SKYTPU_JOURNAL_PATH', str(tmp_path / 'j.db'))
    servers = []
    try:
        store = block_store.BlockStore(str(tmp_path / 'dir'))
        store_srv, _, store_url = _replica(params, store=store)
        servers.append(store_srv)
        assert store_srv.role == 'mixed'
        status, stats = _http(store_url, '/prefix_blocks')
        assert (status, stats) == (200, store.stats())
        for raw in (b'{not json', b'[1, 2]', b'{"prompt": "ab"}'):
            status, body = _http(store_url, '/prefix_blocks', raw=raw)
            assert status == 400, raw
        plain, _, url = _replica(params)
        servers.append(plain)
        assert _http(url, '/prefix_blocks') == (
            404, {'error': 'no block store hosted here'})
        status, body = _http(url, '/prewarm', {'digests': ['a']})
        assert status == 404 and 'SKYTPU_STORE_URL' in body['error']
        dense = model_server.ModelServer(
            model_server.build_engine('debug', 1, 32, device='cpu',
                                      params=params, store_url=store_url),
            0, host='127.0.0.1')
        servers.append(dense)
        url_dense = f'http://127.0.0.1:{dense.start()}'
        assert _http(url_dense, '/prewarm', {'digests': ['a']}) == (
            400, {'ok': False, 'error': 'replica is not paged'})
        srv, _, url = _replica(params, store_url=store_url)
        servers.append(srv)
        for raw in (b'{not json', b'{"digests": 3}', b'{}'):
            status, body = _http(url, '/prewarm', raw=raw)
            assert status == 400 and 'digests' in body['error'], raw
        monkeypatch.setenv('SKYTPU_CHAOS', 'store_down')
        assert _http(url, '/prewarm', {'digests': ['a', 'b']}) == (
            200, {'ok': True, 'warmed': 0, 'missed': 2, 'tokens': 0})
        monkeypatch.delenv('SKYTPU_CHAOS')
        monkeypatch.setenv('SKYTPU_PREWARM_MAX_DIGESTS', '1')
        assert _http(url, '/prewarm', {'digests': ['a', 'b']})[1][
            'missed'] == 1
    finally:
        for srv in servers:
            srv.stop()


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the paged-decode kernel runs only '
                    'on the card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_cuda_store_round_trip(cuda, kv, tmp_path):
    """On the card: an owner spills through the store's wire format, a
    fresh replica warmed from the store decodes through the paged-decode
    kernel (n_layers launches a decode step) to the owner's own answer
    over its cache, with the owner's blocks."""
    params = tllama.init_params(
        CFG, torch.Generator(device=cuda).manual_seed(0), cuda)
    store = block_store.BlockStore(str(tmp_path / 'store'))
    shared = _shared_prefix()
    owner = _engine(params, kv, store_url='store://fleet',
                    store_fetch_fn=_store_fetch(store),
                    store_spill_fn=_store_spill(store))
    _drive(owner, [engine_lib.Request(shared + [1, 2, 3], 6)])
    _pump_spills(owner, store)
    prompt = shared + [5, 6, 7, 8]
    want = engine_lib.Request(prompt, 8)
    _drive(owner, [want])
    fetcher = _engine(params, kv, store_url='store://fleet',
                      store_fetch_fn=_store_fetch(store),
                      store_spill_fn=_no_spill)
    launched = da.paged_decode_attention_kernel.launches
    got = engine_lib.Request(prompt, 8)
    _drive(fetcher, [got])
    torch.cuda.synchronize()
    steps = fetcher.stats()['decode_steps']
    assert steps and (da.paged_decode_attention_kernel.launches - launched
                      == CFG.n_layers * steps)
    assert got.tokens == want.tokens
    assert fetcher.cache_stats()['store_fetch_hits'] == 1
    mine, theirs = _export_run(fetcher, shared), _export_run(owner, shared)
    for name, t in theirs['arrays'].items():
        assert torch.equal(mine['arrays'][name], t), name
