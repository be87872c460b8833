"""Port disaggregated prefill/decode handoff (skypilot_tpu_torch/models/
engine.py's handoff section, ``prefix_transfer.http_push`` and the model
server's ``/prefill_handoff`` and ``/handoff_blocks``) on the ``debug``
config, block_k 8, a 28-token prompt (3 full blocks and a 4-token tail)
and prefill_chunk 8, with the reference's weights bridged through numpy.

* Port to port, the counterparts of tests/unit_tests/test_disagg.py (all
  but the tensor-parallel case, which the port has not): a handed-off
  stream gives monolithic serving's tokens and the JAX reference's (bf16
  and int8 K/V); a failed push degrades in place and backs the peer off;
  a peer draining mid-handoff leaves both sides consistent; a short
  prompt degrades before any push.
* Across the packages, in process, through the JSON wire format: a JAX
  prefill engine hands off to a port decode engine and a port prefill
  engine to a JAX decode engine, with identical greedy tokens and the
  pushed bytes installed as they were sent. The blocks each package
  pushes for the same prompt are compared in a subprocess with XLA's
  excess precision off: int8 bit for bit, bf16 bit for bit in layer 0
  and within one bf16 ulp after it.
* Over HTTP, two port replicas on localhost: ``/prefill_handoff`` →
  ``complete`` → ``/generate`` on the decode replica; the chaos points
  ``handoff_decode_death`` and ``handoff_truncate`` and the admission
  degrades (untrusted and missing target) answer with the full token
  count; ``/handoff_blocks``'s refusals.
* The JAX package's own load balancer, ``disagg`` policy, in front of a
  port prefill replica and a port decode replica: it learns both roles
  from the port's ``/slo`` and serves a request through both legs.

Every wait has its own limit: pollers end within 30 s, every request
carries a timeout, push budgets are explicit, and servers, engine loops
and the load balancer stop in ``finally``.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import prefix_transfer as jtransfer
from skypilot_tpu.observability import metrics as jmetrics
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import prefix_transfer
from skypilot_tpu_torch.observability import journal
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.utils import chaos

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']
BLOCK_K = 8
JPARAMS = jllama.init_params(jax.random.PRNGKey(0), JCFG)
PARAMS = convert.params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG)
# Every push in these tests has this budget, and every wait a limit.
PUSH_BUDGET = 10.0
WAIT_SECONDS = 30.0
HTTP_TIMEOUT = 60


@pytest.fixture(autouse=True)
def fresh_registry():
    prev = [m.set_registry(m.MetricsRegistry()) for m in (metrics,
                                                          jmetrics)]
    chaos.reset()
    yield
    metrics.set_registry(prev[0])
    jmetrics.set_registry(prev[1])


def _engine(kv='bf16', **kwargs):
    # Every engine, the controls too, admits through the chunked path, so
    # parity compares the handoff against the same prefill schedule.
    kwargs.setdefault('prefill_chunk', BLOCK_K)
    return engine_lib.DecodeEngine(
        PARAMS, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=BLOCK_K,
                                          kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, **kwargs)


def _jengine(kv='bf16', **kwargs):
    return jengine.DecodeEngine(
        JPARAMS, JCFG, jdecode.DecodeConfig(max_len=64, temperature=0.0,
                                            decode_attention='xla',
                                            kernel_block_k=BLOCK_K,
                                            kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, prefill_chunk=BLOCK_K,
        name='t-torch-disagg', **kwargs)


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < 2000, 'engine wedged'


def _wait(req, timeout=WAIT_SECONDS):
    assert req.wait(timeout), 'request not answered in time'


@contextlib.contextmanager
def _loop(eng):
    """The decode engine's loop thread for the with-block: a push resolves
    only when a live loop on the decode side serves the injection (the
    handshake ``/handoff_blocks`` rides)."""
    stop = threading.Event()
    thread = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=10)
        assert not thread.is_alive(), 'engine loop did not stop'


def _wire_push(inject, encode=prefix_transfer.encode_payload,
               decode=prefix_transfer.decode_payload, sent=None):
    """A push through the whole wire format: the prefill engine's host
    snapshot, ``encode``, a JSON round trip, ``decode``, the decode
    engine's loop-served injection (either side may be either package's).
    ``sent`` collects the decoded payloads."""

    def push(tokens, payload):
        enc = encode(payload['matched_tokens'], payload['from_tokens'],
                     payload['block_k'], payload['kv_cache_dtype'],
                     payload['arrays'])
        dec = decode(json.loads(json.dumps(enc)))
        if sent is not None:
            sent.append(dec)
        return bool(inject(tokens, dec, timeout=PUSH_BUDGET).get('ok'))

    return push


def _prompt(seed=3, n=28):
    # The reference test's tie-free seeds; 28 tokens = 3 full blocks and a
    # 4-token tail the decode side prefills itself.
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=n).tolist()


def _handoff_rows(eng):
    eng.flush_journal()
    return [e['payload'] for e in journal.query(
        kinds=[journal.EventKind.ENGINE_HANDOFF], db_path=eng.journal_db)]


def _blocks(eng, tokens):
    raw = eng._export_prefix_now(tokens, 0)  # pylint: disable=protected-access
    return raw['arrays']


@pytest.fixture(scope='module')
def jax_tokens():
    """The JAX reference's chunked paged engine's greedy tokens, per K/V
    dtype and prompt seed."""
    memo = {}

    def tokens(kv, seed):
        if (kv, seed) not in memo:
            jr = jengine.Request(_prompt(seed), 8)
            _drive(_jengine(kv), [jr])
            memo[kv, seed] = jr.tokens
        return memo[kv, seed]

    return tokens


# ------------------------------------------------------------ port to port


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_handoff_parity(kv, jax_tokens, tmp_path):
    """A handed-off stream is token for token monolithic serving's and the
    JAX reference's. The prefill engine streams its full blocks chunk by
    chunk and frees them; the decode engine installs them incrementally
    and prefills the 4-token tail itself; the installed blocks are the
    prefill engine's, bit for bit."""
    prompt = _prompt(3)
    prefill = _engine(kv, name='hp-p', journal_db=str(tmp_path / 'p.db'))
    dec = _engine(kv, name='hp-d', journal_db=str(tmp_path / 'd.db'))
    sent = []
    r = engine_lib.Request(prompt, 8)
    r.handoff_push = _wire_push(dec.inject_handoff_blocks, sent=sent)
    r.handoff_peer = 'hp-d'
    with _loop(dec):
        _drive(prefill, [r])
        assert r.finish_reason == 'handoff' and not r.tokens
        rd = engine_lib.Request(prompt, 8)
        dec.submit(rd)
        _wait(rd)
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(kv, name='hp-c'), [rc])
    assert rd.tokens == rc.tokens == jax_tokens(kv, 3)
    ph, dh = prefill.handoff_stats(), dec.handoff_stats()
    assert ph == {'completed': 1, 'degraded': 0, 'tokens_pushed': 24,
                  'injections': 0, 'tokens_injected': 0}
    assert dh['injections'] == 3 and dh['tokens_injected'] == 24
    assert prefill.stats()['handoffs_completed'] == 1
    assert dec.stats()['handoff_injections'] == 3
    # One push per chunk, each of the blocks that chunk finished.
    assert [(p['from_tokens'], p['matched_tokens']) for p in sent] == [
        (0, 8), (8, 16), (16, 24)]
    # The prefill pool turned over: nothing published, nothing held.
    assert prefill.stats()['blocks_used'] == 0
    assert dec.cache_stats()['prefill_tokens_saved'] >= 24
    got = _blocks(dec, prompt[:24])
    for name, t in got.items():
        want = torch.cat([p['arrays'][name] for p in sent], dim=1)
        assert torch.equal(t, want), name
    done = [e for e in _handoff_rows(prefill)
            if e.get('outcome') == 'complete']
    assert len(done) == 1 and done[0]['tokens_pushed'] == 24
    assert done[0]['peer'] == 'hp-d'
    assert [e['outcome'] for e in _handoff_rows(dec)] == ['inject'] * 3
    text = metrics.generate_latest().decode()
    assert 'skytpu_engine_handoffs_total{result="complete"} 1' in text
    assert 'skytpu_engine_handoffs_total{result="inject"} 3' in text


def test_handoff_push_failure_degrades_in_place(tmp_path):
    """A peer refusing the push degrades the slot to decode-in-place: the
    request is answered with monolithic serving's tokens, the peer goes
    into backoff, and the degrade is journaled with its reason."""
    prompt = _prompt(7)
    prefill = _engine(name='pf-p', journal_db=str(tmp_path / 'p.db'))
    r = engine_lib.Request(prompt, 8)
    r.handoff_push = lambda toks, payload: False
    r.handoff_peer = 'dead-peer'
    _drive(prefill, [r])
    assert r.done and r.finish_reason == 'length'
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(name='pf-c'), [rc])
    assert r.tokens == rc.tokens
    st = prefill.handoff_stats()
    assert st['degraded'] == 1 and st['completed'] == 0
    assert st['tokens_pushed'] == 0
    assert prefill.peer_in_backoff('dead-peer')
    rows = _handoff_rows(prefill)
    assert [(e['outcome'], e['reason']) for e in rows] == [
        ('degraded', 'push_failed')]
    text = metrics.generate_latest().decode()
    assert 'skytpu_engine_handoffs_total{result="degraded"} 1' in text


def test_push_raise_and_export_failure_degrade(monkeypatch):
    """A transport that raises, and a host copy that fails, degrade the
    same way: answered in place, never raised into the step."""
    prompt = _prompt(7)
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(name='px-c'), [rc])

    def boom(toks, payload):
        raise ConnectionError('peer gone')

    prefill = _engine(name='px-p')
    r = engine_lib.Request(prompt, 8)
    r.handoff_push, r.handoff_peer = boom, 'peer'
    _drive(prefill, [r])
    assert r.tokens == rc.tokens
    assert prefill.handoff_stats()['degraded'] == 1

    def bad_export(pool, idx):
        raise RuntimeError('device read failed')

    monkeypatch.setattr(tdecode, 'export_pool_blocks', bad_export)
    prefill = _engine(name='px-q')
    r = engine_lib.Request(prompt, 8)
    r.handoff_push, r.handoff_peer = (lambda toks, payload: True), 'peer'
    _drive(prefill, [r])
    assert r.tokens == rc.tokens
    assert prefill.handoff_stats() == {
        'completed': 0, 'degraded': 1, 'tokens_pushed': 0,
        'injections': 0, 'tokens_injected': 0}
    assert prefill.peer_in_backoff('peer')


def test_drain_mid_handoff_degrades_and_peer_stays_consistent():
    """A decode peer that starts draining after the first chunk landed
    (its refusals are what a draining server's 503s become) degrades the
    prefill side to decode-in-place with the same tokens, and leaves the
    peer's radix cache hole-free: the same prompt then serves correctly
    there off the one acked chunk."""
    prompt = _prompt(9)
    prefill = _engine(name='dr-p')
    dec = _engine(name='dr-d')
    draining = threading.Event()
    wire = _wire_push(dec.inject_handoff_blocks)

    def push(tokens, payload):
        if draining.is_set():
            return False
        draining.set()
        return wire(tokens, payload)

    r = engine_lib.Request(prompt, 8)
    r.handoff_push, r.handoff_peer = push, 'dr-d'
    with _loop(dec):
        _drive(prefill, [r])
        assert r.finish_reason == 'length' and r.tokens
        rd = engine_lib.Request(prompt, 8)
        dec.submit(rd)
        _wait(rd)
    assert rd.tokens == r.tokens
    st = prefill.handoff_stats()
    assert st['degraded'] == 1 and st['completed'] == 0
    assert st['tokens_pushed'] == BLOCK_K
    assert dec.handoff_stats()['tokens_injected'] == BLOCK_K


def test_short_prompt_degrades_before_any_push(tmp_path):
    """A prompt shorter than one block has nothing aligned to hand off:
    the push is disarmed at admission and the transport never called."""
    prefill = _engine(name='sp-p', journal_db=str(tmp_path / 'p.db'))
    calls = []
    r = engine_lib.Request([1, 2, 3], 4)
    r.handoff_push = lambda toks, payload: calls.append(1) or True
    r.handoff_peer = 'peer'
    _drive(prefill, [r])
    assert r.done and len(r.tokens) == 4 and not calls
    assert prefill.handoff_stats()['degraded'] == 1
    assert [(e['outcome'], e['reason'], e['prompt_len'])
            for e in _handoff_rows(prefill)] == [
                ('degraded', 'short_prompt', 3)]


def test_handoff_without_chunking_is_one_chunk():
    """With chunking off a handoff still takes the chunked path, as one
    chunk of the whole suffix, and pushes its 3 full blocks at once."""
    prompt = _prompt(3)
    prefill = _engine(name='one-p', prefill_chunk=0)
    dec = _engine(name='one-d', prefill_chunk=0)
    sent = []
    r = engine_lib.Request(prompt, 8)
    r.handoff_push = _wire_push(dec.inject_handoff_blocks, sent=sent)
    with _loop(dec):
        _drive(prefill, [r])
        assert r.finish_reason == 'handoff'
        rd = engine_lib.Request(prompt, 8)
        dec.submit(rd)
        _wait(rd)
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(name='one-c', prefill_chunk=0), [rc])
    assert rd.tokens == rc.tokens
    assert [(p['from_tokens'], p['matched_tokens']) for p in sent] == [
        (0, 24)]
    assert prefill.stats()['prefill_chunks'] == 1


def test_inject_refuses_gaps_and_malformed_and_is_idempotent():
    """The decode side alone: a push past its coverage is a ``gap``, a
    misaligned one ``malformed``, a repeat an ok no-op; an unpaged engine
    answers ``not_paged``; the refs come back on every path."""
    prompt = _prompt(3)
    src = _engine(name='inj-s')
    _drive(src, [engine_lib.Request(prompt, 2)])
    raw = src._export_prefix_now(prompt[:24], 0)  # pylint: disable=protected-access
    first = dict(raw, matched_tokens=8,
                 arrays={n: a[:, :1] for n, a in raw['arrays'].items()})
    later = dict(raw, from_tokens=16, matched_tokens=24,
                 arrays={n: a[:, 2:] for n, a in raw['arrays'].items()})
    dec = _engine(name='inj-d')
    inject = dec._inject_handoff_now  # pylint: disable=protected-access
    assert inject(prompt, later) == {'ok': False, 'error': 'gap'}
    assert inject(prompt, dict(first, matched_tokens=5)) == {
        'ok': False, 'error': 'malformed'}
    assert inject(prompt, first) == {'ok': True, 'gained': 8}
    assert inject(prompt, first) == {'ok': True, 'gained': 0}
    # A push that overlaps the coverage installs only what is new.
    assert inject(prompt, raw) == {'ok': True, 'gained': 16}
    assert dec.handoff_stats()['tokens_injected'] == 24
    # Only the radix cache holds the blocks: every match ref came back.
    assert dec._allocator.used() == 3  # pylint: disable=protected-access
    dense = engine_lib.DecodeEngine(
        PARAMS, CFG, tdecode.DecodeConfig(max_len=64), 1)
    assert dense.inject_handoff_blocks(prompt, raw, timeout=1.0) == {
        'ok': False, 'error': 'not_paged'}


def test_supervisor_restart_drops_an_inflight_push():
    """A crash while a push is in flight fails the request, shuts the
    pushes' executor down and rebuilds; the abandoned push never touches
    the new pool, and the next handoff runs on a fresh executor."""
    prompt = _prompt(3)
    release = threading.Event()
    prefill = _engine(name='rs-p')
    r = engine_lib.Request(prompt, 8)

    def slow_push(tokens, payload):
        release.wait(WAIT_SECONDS)
        return True

    r.handoff_push, r.handoff_peer = slow_push, 'peer'
    prefill.submit(r)
    prefill._admit()  # pylint: disable=protected-access
    prefill._advance_prefill()  # chunk 1, whose push now waits  # pylint: disable=protected-access
    old_pool = prefill._handoff_pool  # pylint: disable=protected-access
    assert old_pool is not None
    assert prefill._prefill_state[0]['hand_fut'][0].running()  # pylint: disable=protected-access
    assert prefill._recover_from_crash(RuntimeError('injected'))  # pylint: disable=protected-access
    assert r.done and r.finish_reason.startswith('error')
    assert prefill._handoff_pool is None  # pylint: disable=protected-access
    release.set()
    assert prefill.stats()['blocks_used'] == 0
    dec = _engine(name='rs-d')
    r2 = engine_lib.Request(prompt, 8)
    r2.handoff_push = _wire_push(dec.inject_handoff_blocks)
    with _loop(dec):
        _drive(prefill, [r2])
    assert r2.finish_reason == 'handoff'
    assert prefill._handoff_pool is not old_pool  # pylint: disable=protected-access


# ------------------------------------------------------------------ interop


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_jax_prefill_to_port_decode(kv, jax_tokens):
    """A JAX prefill engine's pushes, through the reference's encoder and
    JSON, install in a port decode engine, which then answers the JAX
    reference's tokens and the port's own; the installed blocks are the
    bytes the JAX side sent."""
    prompt = _prompt(3)
    dec = _engine(kv, name='jp-d')
    sent = []
    jr = jengine.Request(prompt, 8)
    jr.handoff_push = _wire_push(dec.inject_handoff_blocks,
                                 encode=jtransfer.encode_payload, sent=sent)
    jr.handoff_peer = 'port-d'
    prefill = _jengine(kv)
    with _loop(dec):
        _drive(prefill, [jr])
        assert jr.finish_reason == 'handoff'
        rd = engine_lib.Request(prompt, 8)
        dec.submit(rd)
        _wait(rd)
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(kv, name='jp-c'), [rc])
    assert rd.tokens == rc.tokens == jax_tokens(kv, 3)
    assert prefill.handoff_stats()['completed'] == 1
    assert dec.handoff_stats()['tokens_injected'] == 24
    for name, t in _blocks(dec, prompt[:24]).items():
        want = torch.cat([p['arrays'][name] for p in sent], dim=1)
        assert torch.equal(t, want), name


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_port_prefill_to_jax_decode(kv, jax_tokens):
    """A port prefill engine's pushes, through the port's encoder and
    JSON, install in a JAX decode engine (the reference's
    ``decode_payload`` and injection), which answers its own tokens and
    the port's; the installed bytes are the port's."""
    prompt = _prompt(3)
    dec = _jengine(kv)
    sent = []
    r = engine_lib.Request(prompt, 8)
    r.handoff_push = _wire_push(dec.inject_handoff_blocks,
                                decode=jtransfer.decode_payload, sent=sent)
    r.handoff_peer = 'jax-d'
    prefill = _engine(kv, name='pj-p')
    with _loop(dec):
        _drive(prefill, [r])
        assert r.finish_reason == 'handoff'
        jd = jengine.Request(prompt, 8)
        dec.submit(jd)
        _wait(jd)
    rc = engine_lib.Request(prompt, 8)
    _drive(_engine(kv, name='pj-c'), [rc])
    assert jd.tokens == rc.tokens == jax_tokens(kv, 3)
    assert prefill.handoff_stats()['tokens_pushed'] == 24
    assert dec.handoff_stats()['tokens_injected'] == 24
    got = dec._export_prefix_now(prompt[:24], 0)['arrays']  # pylint: disable=protected-access
    for name, a in got.items():
        want = np.concatenate([p['arrays'][name] for p in sent], axis=1)
        assert np.asarray(a).tobytes() == want.tobytes(), name


# The payloads a JAX chunked prefill engine pushes for one prompt,
# compiled with XLA's excess precision off, encoded by the reference and
# written as JSON (a fresh process: XLA reads its flags once).
_JAX_PUSHES = """
import json, sys
import jax
from skypilot_tpu.models import decode, engine, llama, prefix_transfer
cfg = llama.CONFIGS['debug']
params = llama.init_params(jax.random.PRNGKey(0), cfg)
prompt = json.loads(sys.argv[1])
out = {}
for kv in ('bf16', 'int8'):
    eng = engine.DecodeEngine(
        params, cfg, decode.DecodeConfig(max_len=64, decode_attention='xla',
                                         kernel_block_k=8,
                                         kv_cache_dtype=kv),
        2, paged=True, num_blocks=33, prefill_chunk=8)
    sent = []

    def push(tokens, payload):
        sent.append(prefix_transfer.encode_payload(
            payload['matched_tokens'], payload['from_tokens'],
            payload['block_k'], payload['kv_cache_dtype'],
            payload['arrays']))
        return True

    req = engine.Request(prompt, 2)
    req.handoff_push = push
    eng.submit(req)
    for _ in range(200):
        if req.done:
            break
        eng.step()
    assert req.finish_reason == 'handoff', req.finish_reason
    out[kv] = sent
with open(sys.argv[2], 'w') as f:
    json.dump(out, f)
"""


def test_pushed_blocks_across_packages_without_excess_precision(tmp_path):
    """With XLA's excess precision off, the blocks a JAX prefill engine
    pushes decode in the port to the blocks a port prefill engine pushes
    for the same prompt, chunk for chunk: int8 values and scale planes
    bit for bit, bf16 bit for bit in layer 0 and within one bf16 ulp in
    later layers (the fp32 accumulation order of the K/V projections, as
    ``test_torch_prefix_fetch.py`` explains)."""
    prompt = _prompt(3)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', PYTHONPATH=root,
               JAX_ENABLE_COMPILATION_CACHE='false',
               XLA_FLAGS='--xla_allow_excess_precision=false')
    out = subprocess.run(
        [sys.executable, '-c', _JAX_PUSHES, json.dumps(prompt),
         str(tmp_path / 'pushes.json')],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / 'pushes.json', encoding='utf-8') as f:
        ref = json.load(f)
    flips = 0
    for kv in ('bf16', 'int8'):
        ours = []
        r = engine_lib.Request(prompt, 2)
        r.handoff_push = lambda toks, payload: ours.append(payload) or True
        _drive(_engine(kv, name='xp-p'), [r])
        assert r.finish_reason == 'handoff'
        theirs = [prefix_transfer.decode_payload(p) for p in ref[kv]]
        assert ([(p['from_tokens'], p['matched_tokens']) for p in theirs]
                == [(p['from_tokens'], p['matched_tokens']) for p in ours]
                == [(0, 8), (8, 16), (16, 24)])
        for mine, other in zip(ours, theirs):
            assert set(mine['arrays']) == set(other['arrays'])
            for name, t in mine['arrays'].items():
                got = other['arrays'][name]
                assert got.dtype == t.dtype, (kv, name)
                if t.dtype != torch.bfloat16:
                    assert torch.equal(got.view(torch.uint8),
                                       t.view(torch.uint8)), (kv, name)
                    continue
                a = got.view(torch.int16).numpy().astype(np.int32)
                b = t.view(torch.int16).numpy().astype(np.int32)
                np.testing.assert_array_equal(a[0], b[0])
                assert (np.abs(a - b) <= 1).all(), (kv, name)
                flips += int((a != b).sum())
    assert flips <= 1, flips


# --------------------------------------------------------------- over HTTP


def _http(url, path, body=None, raw=None, headers=None):
    """(status, headers, parsed body): JSON, or the SSE events' list."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
            status, hdrs, text = resp.status, dict(resp.headers), \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        status, hdrs, text = e.code, dict(e.headers), e.read().decode()
    if hdrs.get('Content-Type') == 'text/event-stream':
        return status, hdrs, [json.loads(line[len('data: '):])
                              for line in text.splitlines()
                              if line.startswith('data: ')]
    return status, hdrs, json.loads(text)


def _replica(role, peers, **kwargs):
    engine = model_server.build_engine(
        'debug', 2, 64, step_chunk=2, paged=True, block_k=BLOCK_K,
        prefill_chunk=BLOCK_K, device='cpu', params=PARAMS,
        prefix_peers=peers, **kwargs)
    server = model_server.ModelServer(engine, 0, host='127.0.0.1',
                                      default_max_new_tokens=6, role=role)
    return server, engine, f'http://127.0.0.1:{server.start()}'


@pytest.fixture
def pair(monkeypatch):
    """A port prefill replica and a port decode replica on localhost,
    each the other's only peer; explicit push budget."""
    monkeypatch.setenv(prefix_transfer.PUSH_BUDGET_ENV, str(PUSH_BUDGET))
    servers = []
    try:
        d_srv, d_eng, d_url = _replica('decode', ['pending'])
        servers.append(d_srv)
        p_srv, p_eng, p_url = _replica('prefill', [d_url])
        servers.append(p_srv)
        d_eng.prefix_peers[:] = [p_url]
        yield p_eng, p_url, d_eng, d_url
    finally:
        for srv in servers:
            srv.stop()


def _control_tokens(prompt, n):
    rc = engine_lib.Request(prompt, n)
    _drive(_engine(name='http-c'), [rc])
    return rc.tokens


def _degraded_total():
    text = metrics.generate_latest().decode()
    for line in text.splitlines():
        if line.startswith('skytpu_engine_handoffs_total{result="degraded"}'):
            return float(line.split()[-1])
    return 0.0


def test_http_prefill_handoff_complete_then_generate(pair):
    """The control: ``/prefill_handoff`` answers ``complete`` with the
    reference's body and header, the prefill replica ran no decode step
    for it, and ``/generate`` on the decode replica answers monolithic
    serving's tokens over the pushed blocks; both replicas' ``/slo``
    carry their role and real handoff counters."""
    p_eng, p_url, d_eng, d_url = pair
    prompt = _prompt(3)
    body = {'prompt': prompt, 'max_new_tokens': 6, 'stream': False}
    status, hdrs, out = _http(
        p_url, '/prefill_handoff', body,
        headers={'X-Skytpu-Handoff-Target': d_url + '/'})
    assert status == 200, out
    assert hdrs['X-Skytpu-Handoff'] == 'complete'
    assert out == {'handoff': 'complete', 'decode_url': d_url,
                   'prompt_len': 28, 'max_new_tokens': 6}
    assert p_eng.stats()['decode_steps'] == 0
    status, _, gen = _http(d_url, '/generate', body)
    assert status == 200
    assert gen['tokens'] == _control_tokens(prompt, 6)
    status, _, slo_p = _http(p_url, '/slo')
    status, _, slo_d = _http(d_url, '/slo')
    assert (slo_p['role'], slo_d['role']) == ('prefill', 'decode')
    assert slo_p['handoff']['completed'] == 1
    assert slo_p['handoff']['tokens_pushed'] == 24
    assert slo_d['handoff']['tokens_injected'] == 24
    assert slo_d['cache']['prefill_tokens_saved'] >= 24
    for url, role, field in ((p_url, 'prefill', 'handoffs_completed=1'),
                             (d_url, 'decode', 'handoff_injections=3')):
        with urllib.request.urlopen(url + '/healthz',
                                    timeout=HTTP_TIMEOUT) as resp:
            health = resp.read().decode()
        assert health.startswith('ok ') and f' role={role} ' in health
        assert f' {field} ' in health


@pytest.mark.parametrize('point', ['handoff_decode_death',
                                   'handoff_truncate'])
@pytest.mark.parametrize('stream', [False, True])
def test_http_chaos_degrades_with_the_full_count(pair, monkeypatch, point,
                                                 stream):
    """The decode replica dying mid-handoff, and a truncated block
    stream, degrade the request to decode-in-place: the prefill replica
    answers ``degraded`` with every token (monolithic serving's), counts
    it, and backs the decode peer off."""
    p_eng, p_url, _, d_url = pair
    monkeypatch.setenv(chaos.CHAOS_ENV, point)
    prompt = _prompt(7)
    status, hdrs, out = _http(
        p_url, '/prefill_handoff',
        {'prompt': prompt, 'max_new_tokens': 6, 'stream': stream},
        headers={'X-Skytpu-Handoff-Target': d_url})
    assert status == 200 and hdrs['X-Skytpu-Handoff'] == 'degraded'
    tokens = ([e['token'] for e in out] if stream else out['tokens'])
    assert tokens == _control_tokens(prompt, 6)
    assert (out[-1] if stream else out)['finish_reason'] == 'length'
    st = p_eng.handoff_stats()
    assert st['degraded'] == 1 and st['completed'] == 0
    assert p_eng.peer_in_backoff(d_url)
    assert _degraded_total() == 1


@pytest.mark.parametrize('target,reason', [
    ('http://127.0.0.1:9', 'untrusted_target'), (None, 'no_target')])
def test_http_admission_degrades(pair, target, reason):
    """A target outside the configured peers, or none, degrades at
    admission: nothing is pushed, the answer has the full count, and the
    degrade is counted and journaled with its reason."""
    p_eng, p_url, d_eng, _ = pair
    prompt = _prompt(7)
    headers = {'X-Skytpu-Handoff-Target': target} if target else {}
    status, hdrs, out = _http(
        p_url, '/prefill_handoff',
        {'prompt': prompt, 'max_new_tokens': 6, 'stream': False},
        headers=headers)
    assert status == 200 and hdrs['X-Skytpu-Handoff'] == 'degraded'
    assert out['tokens'] == _control_tokens(prompt, 6)
    assert _degraded_total() == 1
    assert p_eng.handoff_stats()['tokens_pushed'] == 0
    assert d_eng.handoff_stats()['injections'] == 0
    rows = journal.query(kinds=[journal.EventKind.ENGINE_HANDOFF])
    assert any(r['payload'].get('reason') == reason for r in rows)


def test_handoff_blocks_refusals(monkeypatch):
    """``/handoff_blocks`` refuses as the reference's: 400 on an unpaged
    replica, 404 without peers (the trust message), 400 for a malformed
    body or payload, and 503 with Retry-After while draining."""
    servers = []
    monkeypatch.setenv('SKYTPU_DRAIN_TIMEOUT_SECONDS', '5')
    try:
        dense = model_server.ModelServer(
            model_server.build_engine('debug', 1, 32, device='cpu',
                                      params=PARAMS), 0, host='127.0.0.1')
        servers.append(dense)
        url = f'http://127.0.0.1:{dense.start()}'
        assert _http(url, '/handoff_blocks', {'prompt': [1]})[::2] == (
            400, {'ok': False, 'error': 'replica is not paged'})
        srv, _, url = _replica('decode', None)
        servers.append(srv)
        status, _, body = _http(url, '/handoff_blocks', {'prompt': [1]})
        assert status == 404 and 'SKYTPU_PREFIX_PEERS' in body['error']
        srv, _, url = _replica('decode', ['http://x:1'])
        servers.append(srv)
        for raw in (b'{not json', b'[1, 2]', b'{"from_tokens": 0}'):
            assert _http(url, '/handoff_blocks', raw=raw)[::2] == (
                400, {'ok': False, 'error': 'malformed body'}), raw
        assert _http(url, '/handoff_blocks', {'prompt': [1]})[::2] == (
            400, {'ok': False, 'error': 'malformed payload'})
        monkeypatch.setenv(chaos.CHAOS_ENV, 'drain_hang')
        assert srv.begin_drain('test')
        status, hdrs, body = _http(url, '/handoff_blocks', {'prompt': [1]})
        assert status == 503 and hdrs['Retry-After'] == '1'
        assert body == {'ok': False, 'error': 'server draining'}
        status, _, _ = _http(url, '/prefill_handoff', {'prompt': [1]})
        assert status == 503
    finally:
        for s in servers:
            s.stop()


# ----------------------------------------------- the JAX package's own fleet


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_jax_load_balancer_disagg_through_port_replicas(pair, monkeypatch):
    """The reference's load balancer, ``disagg`` policy, in front of a
    port prefill replica and a port decode replica: it learns both roles
    from the port's ``/slo``, sends the prefill leg to
    ``/prefill_handoff`` with the decode target, and the decode leg's
    ``/generate`` answers the request over the pushed blocks."""
    import requests
    from skypilot_tpu.serve import load_balancer as lb_lib
    monkeypatch.setenv('SKYTPU_FLEET_SLO_INTERVAL', '0.2')
    p_eng, p_url, d_eng, d_url = pair
    lb = lb_lib.LoadBalancer(_free_port(), 'disagg',
                             get_ready_urls=lambda: [p_url, d_url])
    lb.start()
    try:
        deadline = time.monotonic() + WAIT_SECONDS
        while ({'prefill', 'decode'} - set(lb.policy.roles().values())
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert lb.policy.roles() == {p_url: 'prefill', d_url: 'decode'}
        prompt = list(range(1, 29))
        r = requests.post(f'http://127.0.0.1:{lb.port}/generate',
                          json={'prompt': prompt, 'max_new_tokens': 6,
                                'stream': False}, timeout=HTTP_TIMEOUT)
        assert r.status_code == 200, r.text
        assert r.json()['generated'] == 6
        assert r.json()['tokens'] == _control_tokens(prompt, 6)
        assert p_eng.handoff_stats()['completed'] == 1
        assert d_eng.handoff_stats()['tokens_injected'] == 24
    finally:
        lb.stop()
