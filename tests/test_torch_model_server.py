"""Port model server (skypilot_tpu_torch/serve/model_server.py) over HTTP
on a CPU engine: the reference server's /generate body and reply shapes
(SSE events and the unary JSON), its 400s, /healthz and /stats, the CLI
refusing flags of unported features, the env knobs of ported ones read
as the reference reads them — and served tokens equal to the JAX
reference's ``decode.generate`` on the same (bridged) weights. The
weights of a replica: ``--int8`` and ``--checkpoint-dir`` parsed and
passed as the reference's CLI does them, a params checkpoint restored
(with and without int8) to the reference's tokens for the same weights,
no complete step serving the random init with the reference's warning,
a trainer checkpoint refused with ValueError in both packages; and a
stopped server releasing its engine without the cyclic collector. The
cross-replica prefix fetch over HTTP: two replicas on localhost, one
pulling the other's blocks through ``/prefix_blocks`` to its tokens;
the endpoint's refusals (400, 404, the self echo, GET 404), ``/journal``
opening to a replica with peers, and ``--prefix-peers`` and the
``SKYTPU_PREFIX_*`` knobs read as the reference reads them. The durable
block store's flags (``--store-url``, ``--store-dir``, ``--role store``)
and knobs (``SKYTPU_STORE_*``, ``SKYTPU_PREWARM_*``, the store role of
``SKYTPU_REPLICA_ROLE``) read as the reference reads them; its endpoints
are in ``tests/test_torch_block_store.py``.
"""
import gc
import io
import json
import logging
import os
import re
import tempfile
import threading
import time
import urllib.error
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import checkpoint as jcheckpoint
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import train as jtrain
from skypilot_tpu.serve import model_server as jserver
from skypilot_tpu_torch.models import block_store, checkpoint
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.serve import model_server

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']


@pytest.fixture(scope='module')
def served():
    """One paged port replica on the CPU with the reference's weights."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tllama.CONFIGS['debug'])
    engine = model_server.build_engine('debug', 2, 64, step_chunk=2,
                                       paged=True, block_k=8, device='cpu',
                                       params=tparams)
    server = model_server.ModelServer(engine, 0, host='127.0.0.1',
                                      default_max_new_tokens=4)
    port = server.start()
    yield jparams, port, engine
    server.stop()


def _post(port, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}/generate',
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _reference(jparams, prompt, n):
    out = jdecode.generate(jparams, jnp.asarray([prompt], jnp.int32),
                           jnp.asarray([len(prompt)], jnp.int32), JCFG,
                           jdecode.DecodeConfig(max_len=64), n)
    return np.asarray(out)[0].tolist()


def test_stream_and_unary_replies_match_reference_tokens(served):
    jparams, port, _ = served
    prompt = np.random.RandomState(3).randint(0, 256, size=11).tolist()
    expect = _reference(jparams, prompt, 6)

    status, headers, text = _post(port, {'prompt': prompt,
                                         'max_new_tokens': 6})
    assert status == 200
    assert headers['Content-Type'] == 'text/event-stream'
    events = [json.loads(line[len('data: '):])
              for line in text.splitlines() if line.startswith('data: ')]
    assert [e['token'] for e in events] == expect
    assert [e['done'] for e in events] == [False] * 5 + [True]
    assert set(events[0]) == {'token', 'text', 'done'}
    assert events[-1]['finish_reason'] == 'length'
    assert events[-1]['generated'] == 6
    assert events[0]['text'] == model_server.decode_tokens([expect[0]])

    status, headers, text = _post(port, {'prompt': prompt,
                                         'max_new_tokens': 6,
                                         'stream': False})
    body = json.loads(text)
    assert status == 200 and headers['X-Request-Id']
    assert body == {'tokens': expect,
                    'text': model_server.decode_tokens(expect),
                    'finish_reason': 'length', 'generated': 6}


def test_text_prompt_and_default_budget(served):
    jparams, port, engine = served
    status, _, text = _post(port, {'text': 'hello', 'stream': False})
    body = json.loads(text)
    assert status == 200 and body['generated'] == 4
    ids = model_server.encode_text('hello', 256)
    assert body['tokens'] == _reference(jparams, ids, 4)
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats['paged'] and stats['admitted'] >= 1
    assert stats['device'] == 'cpu'
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/healthz',
                                timeout=30) as resp:
        assert resp.status == 200 and resp.read().startswith(b'ok ')
    assert engine.stats()['failed'] is False


@pytest.mark.parametrize('body,raw,needle', [
    (None, b'{not json', 'invalid JSON'),
    ({'nothing': 1}, None, 'needs "prompt"'),
    ({'prompt': 'abc'}, None, 'list of token ids'),
    ({'prompt': []}, None, 'empty prompt'),
    ({'prompt': [1], 'max_new_tokens': 'x'}, None, 'must be an integer'),
    ({'prompt': [1] * 64}, None, 'prompt too long'),
])
def test_bad_bodies_answer_400(served, body, raw, needle):
    _, port, _ = served
    status, _, text = _post(port, body, raw)
    assert status == 400
    assert needle in json.loads(text)['error']


def test_cli_refuses_unported_features_and_needs_a_device(monkeypatch):
    # Nothing of the reference's CLI is refused any more: --tp is read as
    # the reference reads it (SKYTPU_SERVE_TP when absent, the flag
    # winning over the env, a malformed env value refused at start).
    assert model_server.parse_args(['--tp', '2']).tp == 2
    assert model_server.parse_args([]).tp is None
    with pytest.raises(SystemExit) as exc:
        model_server.parse_args(['--tp', 'two'])
    assert exc.value.code == 2
    monkeypatch.setenv(model_server.SERVE_TP_ENV, '4')
    assert model_server.serve_tp(None) == 4
    assert model_server.serve_tp(2) == 2
    monkeypatch.setenv(model_server.SERVE_TP_ENV, 'two')
    with pytest.raises(ValueError):
        model_server.serve_tp(None)
    with pytest.raises(ValueError):
        model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                  device='cpu')
    monkeypatch.delenv(model_server.SERVE_TP_ENV)
    args = model_server.parse_args(['--paged', '--kv-int8', '--attn',
                                    'plain', '--device', 'cpu',
                                    '--prefill-chunk', '64'])
    assert args.paged and args.kv_int8 and args.device == 'cpu'
    assert args.prefill_chunk == 64
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    prefill_chunk=args.prefill_chunk,
                                    device='cpu')
    assert eng.prefill_chunk == 64
    # SKYTPU_PREFILL_CHUNK reaches a paged engine; dense ignores it, as
    # the reference does; an explicit argument wins.
    monkeypatch.setenv('SKYTPU_PREFILL_CHUNK', '64')
    assert model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                     device='cpu').prefill_chunk == 64
    assert model_server.build_engine('debug', 1, 32,
                                     device='cpu').prefill_chunk == 0
    assert model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                     prefill_chunk=0,
                                     device='cpu').prefill_chunk == 0


# (knob, value, the feature its refusal names, or None where the value
# is the reference's default or what the reference degrades to it). The
# port refuses no knob of the reference's any more; SKYTPU_SERVE_TP is
# read (ENV_READ_CASES).
ENV_KNOB_CASES = [
    ('SKYTPU_REPLICA_ROLE', 'mixed', None),
    ('SKYTPU_REPLICA_ROLE', 'MIXED ', None),
    ('SKYTPU_REPLICA_ROLE', 'prefil', None),
]


@pytest.mark.parametrize('name,value,feature', ENV_KNOB_CASES)
def test_env_knobs_of_unported_features_are_refused_unless_default(
        monkeypatch, name, value, feature):
    """A knob the reference's replica reads is refused at any value that
    would change the reference's behaviour, and accepted at its default
    or at what the reference's own parsing degrades to the default."""
    monkeypatch.setenv(name, value)
    if feature is None:
        eng = model_server.build_engine('debug', 1, 32, device='cpu')
        assert eng.num_slots == 1
    else:
        with pytest.raises(ValueError, match=re.escape(feature)):
            model_server.build_engine('debug', 1, 32, device='cpu')


def _server_reading(name):
    """What the built server reads for a server knob."""
    srv = model_server.ModelServer(
        model_server.build_engine('debug', 1, 32, device='cpu'), 0)
    return {'SKYTPU_SERVE_MAX_QUEUE': srv.max_queue,
            'SKYTPU_DRAIN_TIMEOUT_SECONDS': srv.drain_timeout,
            'SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS': srv.max_staleness}[name]


def _profiler_reading(name):
    prof = model_server.build_engine('debug', 1, 32, device='cpu').profiler
    return {'SKYTPU_ENGINE_STEP_RING': prof.capacity,
            'SKYTPU_ENGINE_STALL_FACTOR': prof.stall_factor,
            'SKYTPU_ENGINE_STALL_MIN_SECONDS': prof.stall_min_seconds}[name]


def _restarts_before_permanent(name):
    """Crashes a fresh engine restarts from before one more fails it for
    good (the restart knobs are read at each crash)."""
    eng = model_server.build_engine('debug', 1, 32, device='cpu')
    n = 0
    while eng._recover_from_crash(RuntimeError('injected')):  # pylint: disable=protected-access
        n += 1
        assert n < 10
    assert eng.failed and eng.restart_count() == n
    return n


def _peers_reading(name):
    """The peers a paged and a dense engine keep from the knob (the
    reference keeps them only when paged)."""
    paged = model_server.build_engine('debug', 1, 32, paged=True,
                                      block_k=8, device='cpu')
    dense = model_server.build_engine('debug', 1, 32, device='cpu')
    return paged.prefix_peers, dense.prefix_peers


def _fetch_knob_reading(name):
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    device='cpu')
    return {'SKYTPU_PREFIX_FETCH_BUDGET_SECONDS': eng.prefix_fetch_budget,
            'SKYTPU_PREFIX_FETCH_MIN_TOKENS': eng._prefix_fetch_min_tokens,  # pylint: disable=protected-access
            'SKYTPU_PREFIX_FETCH_BACKOFF_SECONDS':
                eng._prefix_fetch_backoff}[name]  # pylint: disable=protected-access


def _role_reading(name):
    """The role a server reads (the reference's: stripped, lowercased,
    anything unknown is mixed), on /healthz's line and /slo."""
    srv = model_server.ModelServer(
        model_server.build_engine('debug', 1, 32, device='cpu'), 0)
    assert srv.health()[1].split()[2] == f'role={srv.role}'
    assert srv.slo()['role'] == srv.role
    return srv.role


def _store_url_reading(name):
    """The store URL a paged and a dense engine keep from the knob (the
    reference keeps it only when paged; blank is no store)."""
    paged = model_server.build_engine('debug', 1, 32, paged=True,
                                      block_k=8, device='cpu')
    dense = model_server.build_engine('debug', 1, 32, device='cpu')
    return paged.store_url, dense.store_url


def _store_knob_reading(name):
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    device='cpu')
    return {
        'SKYTPU_STORE_FETCH_BUDGET_SECONDS': eng._store_fetch_budget,  # pylint: disable=protected-access
        'SKYTPU_STORE_SPILL_BUDGET_SECONDS': eng._store_spill_budget,  # pylint: disable=protected-access
        'SKYTPU_STORE_BACKOFF_SECONDS': eng._store_backoff,  # pylint: disable=protected-access
        'SKYTPU_STORE_SPILL_MIN_TOKENS':
            eng._store_spill_min_tokens}[name]  # pylint: disable=protected-access


def _block_store_reading(name):
    """What a block store opened with no arguments reads: its capacity
    and its family window (the family digest's too)."""
    with tempfile.TemporaryDirectory() as root:
        store = block_store.BlockStore(root)
    window = store._family_tokens  # pylint: disable=protected-access
    run = list(range(300))
    assert block_store.family_digest(run) == block_store.family_digest(
        run, window)
    return {'SKYTPU_STORE_CAPACITY_BYTES': store.capacity_bytes,
            'SKYTPU_STORE_FAMILY_TOKENS': window}[name]


class _PostHandler:
    """A handler stand-in carrying one JSON body (the prewarm readings
    run the handler without a socket)."""

    def __init__(self, body):
        data = json.dumps(body).encode()
        self.headers = {'Content-Length': str(len(data))}
        self.rfile = io.BytesIO(data)
        self.sent = None

    def send_json(self, status, obj, headers=None):
        self.sent = (status, obj)


def _prewarm_reading(name):
    """(digests a /prewarm of ten pulls from the store, the budget each
    pull gets), both read per request."""
    srv = model_server.ModelServer(
        model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                  device='cpu', store_url='http://store:1'),
        0)
    srv._state = 'running'  # pylint: disable=protected-access
    calls = []
    real = block_store.http_store_prewarm_fetch
    block_store.http_store_prewarm_fetch = (
        lambda url, digest, budget: calls.append(budget))
    try:
        h = _PostHandler({'digests': [str(i) for i in range(10)]})
        srv.handle_prewarm(h)
    finally:
        block_store.http_store_prewarm_fetch = real
    assert h.sent == (200, {'ok': True, 'warmed': 0, 'missed': len(calls),
                            'tokens': 0})
    assert len(set(calls)) == 1
    return len(calls), calls[0]


def _push_budget_reading(name):
    """The push budget the server hands each handoff's transport, and the
    engine's wait for one push (twice the budget, at least 1 s)."""
    budget = model_server.ModelServer.push_budget()
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    device='cpu')
    waits = []

    class _Fut:
        def result(self, timeout):
            waits.append(timeout)
            return True

    st = {'req': engine_lib.Request([1], 1), 'pushed': 0,
          'hand_fut': (_Fut(), 1, 0)}
    assert eng._await_handoff_ack(st)  # pylint: disable=protected-access
    assert waits == [max(2 * budget, 1.0)]
    return budget


def _tp_reading(name):
    """The TP degree a built replica reads from the knob: the engine's at
    1; above 1, the refusal a dense replica gives exactly as the
    reference's does (the degree was read, and TP needs a paged pool)."""
    try:
        return model_server.build_engine('debug', 1, 32, device='cpu').tp
    except ValueError as e:
        assert 'requires paged' in str(e), e
        return model_server.serve_tp()


def _stop_wait(name):
    """How long stop() waits for an engine thread that will not end for
    5 s: the knob's 0.2 when it gave up after at least 0.2 s and well
    before the thread ended, else the seconds it took."""
    srv = model_server.ModelServer(
        model_server.build_engine('debug', 1, 32, device='cpu'), 0)
    srv._engine_thread = threading.Thread(target=time.sleep, args=(5,),  # pylint: disable=protected-access
                                          daemon=True)
    srv._engine_thread.start()  # pylint: disable=protected-access
    t0 = time.perf_counter()
    srv.stop()
    waited = time.perf_counter() - t0
    return 0.2 if 0.2 <= waited < 4 else waited


# (knob, value, how to read it, what the reference reads): the knobs of
# ported features, each read as the reference reads it (an unparseable
# value gives the default, except SKYTPU_SERVE_TP's, which the reference
# refuses: test_cli_refuses_unported_features_and_needs_a_device).
ENV_READ_CASES = [
    ('SKYTPU_SERVE_MAX_QUEUE', '64', _server_reading, 64),
    ('SKYTPU_SERVE_MAX_QUEUE', '0', _server_reading, 0),
    ('SKYTPU_SERVE_MAX_QUEUE', 'lots', _server_reading, 256),
    ('SKYTPU_DRAIN_TIMEOUT_SECONDS', '5', _server_reading, 5.0),
    ('SKYTPU_DRAIN_TIMEOUT_SECONDS', '30.0', _server_reading, 30.0),
    ('SKYTPU_DRAIN_TIMEOUT_SECONDS', 'soon', _server_reading, 30.0),
    ('SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS', '10', _server_reading, 10.0),
    ('SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS', 'never', _server_reading,
     None),
    ('SKYTPU_ENGINE_MAX_RESTARTS', '0', _restarts_before_permanent, 0),
    ('SKYTPU_ENGINE_MAX_RESTARTS', '3', _restarts_before_permanent, 3),
    ('SKYTPU_ENGINE_MAX_RESTARTS', 'many', _restarts_before_permanent, 3),
    ('SKYTPU_ENGINE_RESTART_WINDOW_SECONDS', '300',
     _restarts_before_permanent, 3),
    ('SKYTPU_SERVER_STOP_TIMEOUT_SECONDS', '0.2', _stop_wait, 0.2),
    ('SKYTPU_ENGINE_STEP_RING', '16', _profiler_reading, 16),
    ('SKYTPU_ENGINE_STEP_RING', 'big', _profiler_reading, 512),
    ('SKYTPU_ENGINE_STALL_FACTOR', '4', _profiler_reading, 4.0),
    ('SKYTPU_ENGINE_STALL_MIN_SECONDS', '0.5', _profiler_reading, 0.5),
    ('SKYTPU_PREFIX_PEERS', 'http://peer:8000', _peers_reading,
     (['http://peer:8000'], [])),
    ('SKYTPU_PREFIX_PEERS', ' http://a:1/, ,http://b:2 ', _peers_reading,
     (['http://a:1/', 'http://b:2'], [])),
    ('SKYTPU_PREFIX_FETCH_BUDGET_SECONDS', '60', _fetch_knob_reading, 60.0),
    ('SKYTPU_PREFIX_FETCH_BUDGET_SECONDS', 'long', _fetch_knob_reading,
     0.5),
    ('SKYTPU_PREFIX_FETCH_MIN_TOKENS', '32', _fetch_knob_reading, 32),
    ('SKYTPU_PREFIX_FETCH_MIN_TOKENS', 'few', _fetch_knob_reading, 8),
    ('SKYTPU_PREFIX_FETCH_BACKOFF_SECONDS', '2.5', _fetch_knob_reading,
     2.5),
    ('SKYTPU_REPLICA_ROLE', 'prefill', _role_reading, 'prefill'),
    ('SKYTPU_REPLICA_ROLE', 'decode', _role_reading, 'decode'),
    ('SKYTPU_REPLICA_ROLE', ' Decode ', _role_reading, 'decode'),
    ('SKYTPU_REPLICA_ROLE', 'mixed', _role_reading, 'mixed'),
    ('SKYTPU_REPLICA_ROLE', 'prefil', _role_reading, 'mixed'),
    ('SKYTPU_REPLICA_ROLE', '', _role_reading, 'mixed'),
    ('SKYTPU_REPLICA_ROLE', 'store', _role_reading, 'store'),
    ('SKYTPU_REPLICA_ROLE', ' Store', _role_reading, 'store'),
    ('SKYTPU_STORE_URL', 'http://store:8000', _store_url_reading,
     ('http://store:8000', None)),
    ('SKYTPU_STORE_URL', ' http://store:8000/ ', _store_url_reading,
     ('http://store:8000/', None)),
    ('SKYTPU_STORE_URL', '  ', _store_url_reading, (None, None)),
    ('SKYTPU_STORE_FETCH_BUDGET_SECONDS', '60', _store_knob_reading, 60.0),
    ('SKYTPU_STORE_FETCH_BUDGET_SECONDS', 'soon', _store_knob_reading, 0.5),
    ('SKYTPU_STORE_SPILL_BUDGET_SECONDS', '5', _store_knob_reading, 5.0),
    ('SKYTPU_STORE_SPILL_BUDGET_SECONDS', '', _store_knob_reading, 2.0),
    ('SKYTPU_STORE_BACKOFF_SECONDS', '2.5', _store_knob_reading, 2.5),
    ('SKYTPU_STORE_SPILL_MIN_TOKENS', '32', _store_knob_reading, 32),
    ('SKYTPU_STORE_SPILL_MIN_TOKENS', '0', _store_knob_reading, 8),
    ('SKYTPU_STORE_CAPACITY_BYTES', '4096', _block_store_reading, 4096),
    ('SKYTPU_STORE_CAPACITY_BYTES', 'big', _block_store_reading, 1 << 30),
    ('SKYTPU_STORE_FAMILY_TOKENS', '16', _block_store_reading, 16),
    ('SKYTPU_STORE_FAMILY_TOKENS', 'x', _block_store_reading, 128),
    ('SKYTPU_PREWARM_MAX_DIGESTS', '2', _prewarm_reading, (2, 2.0)),
    ('SKYTPU_PREWARM_MAX_DIGESTS', 'lots', _prewarm_reading, (8, 2.0)),
    ('SKYTPU_PREWARM_BUDGET_SECONDS', '7.5', _prewarm_reading, (8, 7.5)),
    ('SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS', '60', _push_budget_reading,
     60.0),
    ('SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS', '0.25', _push_budget_reading,
     0.25),
    ('SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS', 'soon', _push_budget_reading,
     2.0),
    ('SKYTPU_SERVE_TP', '1', _tp_reading, 1),
    ('SKYTPU_SERVE_TP', '', _tp_reading, 1),
    ('SKYTPU_SERVE_TP', '2', _tp_reading, 2),
    ('SKYTPU_SERVE_TP', ' 4 ', _tp_reading, 4),
]


@pytest.mark.parametrize('name,value,read,want', ENV_READ_CASES)
def test_env_knobs_of_ported_features_are_read_as_the_reference(
        monkeypatch, name, value, read, want):
    monkeypatch.setenv(name, value)
    assert read(name) == want


def test_spec_flags_and_envs_reach_the_decode_config(monkeypatch):
    args = model_server.parse_args(['--spec-k', '2', '--drafter-layers',
                                    '1', '--paged', '--device', 'cpu'])
    assert (args.spec_k, args.drafter_layers, args.paged) == (2, 1, True)
    eng = model_server.build_engine('debug', 1, 32, paged=True,
                                    block_k=8, spec_k=args.spec_k,
                                    drafter_layers=args.drafter_layers,
                                    device='cpu')
    assert (eng.dcfg.spec_k, eng.dcfg.spec_drafter_layers) == (2, 1)
    monkeypatch.setenv('SKYTPU_SPEC_K', '3')
    monkeypatch.setenv('SKYTPU_SPEC_DRAFTER_LAYERS', '9')
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    device='cpu')
    # The drafter depth clamps to the model's 2 layers, as the reference.
    assert (eng.dcfg.spec_k, eng.dcfg.spec_drafter_layers) == (3, 2)
    # An explicit argument wins over the environment.
    eng = model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                    spec_k=0, device='cpu')
    assert eng.dcfg.spec_k == 0
    with pytest.raises(ValueError, match='paged'):
        model_server.build_engine('debug', 1, 32, device='cpu')
    with pytest.raises(ValueError, match='greedy'):
        model_server.build_engine('debug', 1, 32, paged=True, block_k=8,
                                  temperature=0.5, device='cpu')


def test_spec_replica_serves_reference_tokens_and_stats_block():
    """A speculative CPU replica answers with the reference's greedy
    tokens and reports its counters under /stats "spec"."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tllama.CONFIGS['debug'])
    engine = model_server.build_engine('debug', 2, 64, paged=True,
                                       block_k=8, spec_k=3,
                                       drafter_layers=1, device='cpu',
                                       params=tparams)
    server = model_server.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    try:
        prompt = np.random.RandomState(3).randint(0, 256, size=11).tolist()
        status, _, text = _post(port, {'prompt': prompt,
                                       'max_new_tokens': 7,
                                       'stream': False})
        assert status == 200
        assert json.loads(text)['tokens'] == _reference(jparams, prompt, 7)
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                    timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.stop()
    spec = stats['spec']
    assert spec['enabled'] and spec['spec_k'] == 3
    assert spec['drafter_layers'] == 1
    assert spec['drafted_total'] == 3 * stats['decode_steps'] > 0
    assert 0 <= spec['accepted_total'] <= spec['drafted_total']
    assert stats['spec_drafted'] == spec['drafted_total']

# ------------------------------------------------- the replica's weights


def test_int8_and_checkpoint_flags_parse_and_reach_build_engine(
        monkeypatch):
    """``--int8`` (store_true) and ``--checkpoint-dir`` (a path, default
    None) parse as the reference's CLI declares them, and ``main()``
    passes both to ``build_engine``."""
    args = model_server.parse_args([])
    assert args.int8 is False and args.checkpoint_dir is None
    args = model_server.parse_args(['--int8', '--checkpoint-dir', '/ckpt',
                                    '--device', 'cpu'])
    assert args.int8 is True and args.checkpoint_dir == '/ckpt'
    seen = {}
    build = model_server.build_engine

    def fake_build(*a, **kw):
        seen.update(kw)
        return build('debug', 1, 32, device='cpu')

    monkeypatch.setattr(model_server, 'build_engine', fake_build)
    monkeypatch.setattr(model_server.ModelServer, 'run_forever',
                        lambda self: None)
    model_server.main(['--int8', '--checkpoint-dir', '/ckpt', '--device',
                       'cpu'])
    assert seen['int8'] is True and seen['checkpoint_dir'] == '/ckpt'


def _greedy(eng, engine_mod, prompts, n=5):
    reqs = [engine_mod.Request(p, n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < 200, 'engine did not converge'
    return [r.tokens for r in reqs]


def _restore_prompts():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 256, size=n).tolist() for n in (5, 11, 3)]


@pytest.fixture(scope='module')
def seed7_ckpt(tmp_path_factory):
    """The reference's seed-7 params, bridged, in the port's params
    checkpoint format (step 11; an interrupted step 12 beside it)."""
    d = str(tmp_path_factory.mktemp('params_ckpt'))
    jparams = jllama.init_params(jax.random.PRNGKey(7), JCFG)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tllama.CONFIGS['debug'])
    checkpoint.save_params(d, tparams, 11)
    os.makedirs(os.path.join(d, 'step_12'))   # no commit marker
    return d


@pytest.mark.parametrize('int8', [False, True])
def test_checkpoint_dir_restores_reference_tokens(seed7_ckpt, int8, caplog):
    prompts = _restore_prompts()
    want = _greedy(jserver.build_engine('debug', 2, 64, attn='xla',
                                        seed=7, int8=int8),
                   jengine, prompts)
    with caplog.at_level(logging.INFO, logger=model_server.__name__):
        eng = model_server.build_engine('debug', 2, 64, attn='plain',
                                        checkpoint_dir=seed7_ckpt,
                                        int8=int8, device='cpu')
    assert f'Restored checkpoint step 11 from {seed7_ckpt}' in caplog.text
    assert _greedy(eng, engine_lib, prompts) == want
    fresh = model_server.build_engine('debug', 2, 64, attn='plain',
                                      int8=int8, device='cpu')
    assert _greedy(fresh, engine_lib, prompts) != want


def test_checkpoint_restore_draws_no_random_init(seed7_ckpt, tmp_path,
                                                monkeypatch):
    """With a complete step the saved tree is checked against meta
    tensors (keys, shapes, the config's dtype), so no random init is
    drawn beside the restored weights."""
    def refuse(*args, **kwargs):
        raise AssertionError('random init drawn beside a checkpoint')

    monkeypatch.setattr(tllama, 'init_params', refuse)
    eng = model_server.build_engine('debug', 2, 64, attn='plain',
                                    checkpoint_dir=seed7_ckpt, device='cpu')
    saved = checkpoint.restore_latest_params(
        seed7_ckpt, eng.params, 'cpu')[0]
    for name, w in eng.params['layers'].items():
        assert w.device.type == 'cpu'
        assert torch.equal(w, saved['layers'][name]), name
    # The config's dtype is part of the template: fp32 weights refused.
    fp32 = {k: ({n: w.float() for n, w in v.items()} if k == 'layers'
                else v.float()) for k, v in saved.items()}
    checkpoint.save_params(str(tmp_path), fp32, 1)
    with pytest.raises(ValueError, match='template'):
        model_server.build_engine('debug', 1, 32, device='cpu',
                                  checkpoint_dir=str(tmp_path))


def test_checkpoint_dir_without_a_complete_step_serves_random_init(
        tmp_path, caplog):
    prompts = _restore_prompts()
    want = _greedy(model_server.build_engine('debug', 2, 64, device='cpu'),
                   engine_lib, prompts)
    os.makedirs(tmp_path / '.step_3.tmp-1')
    with caplog.at_level(logging.WARNING, logger=model_server.__name__):
        eng = model_server.build_engine('debug', 2, 64,
                                        checkpoint_dir=str(tmp_path),
                                        device='cpu')
    assert (f'No complete checkpoint under {tmp_path}; serving random '
            'init.') in caplog.text
    assert _greedy(eng, engine_lib, prompts) == want


def test_trainer_checkpoint_is_refused_as_the_reference_refuses_it(
        tmp_path):
    """A trainer checkpoint is a TrainState, not a params tree: both
    replicas raise ValueError rather than serve it."""
    tcfg = tllama.CONFIGS['debug']
    state = ttrain.init_train_state(tcfg, ttrain.TrainConfig(), 'cpu')
    checkpoint.save(str(tmp_path / 'port'), state, 5)
    with pytest.raises(ValueError, match='does not match'):
        model_server.build_engine('debug', 1, 32, device='cpu',
                                  checkpoint_dir=str(tmp_path / 'port'))
    # Another config's params: the shapes differ.
    other = tllama.init_params(tllama.CONFIGS['bench-cpu'],
                               torch.Generator().manual_seed(0))
    checkpoint.save_params(str(tmp_path / 'other'), other, 1)
    with pytest.raises(ValueError, match='template'):
        model_server.build_engine('debug', 1, 32, device='cpu',
                                  checkpoint_dir=str(tmp_path / 'other'))
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), JCFG,
                                     jtrain.TrainConfig())
    jcheckpoint.save(str(tmp_path / 'ref'), jstate, 5)
    with pytest.raises(ValueError):
        jserver.build_engine('debug', 1, 32, attn='xla',
                             checkpoint_dir=str(tmp_path / 'ref'))


def test_stopped_server_releases_engine_without_cyclic_collector():
    """stop() and the caller's last reference free the engine (and its
    cache) by reference counting alone: nothing of the server keeps a
    cycle through it."""
    gc.collect()
    gc.disable()
    try:
        engine = model_server.build_engine('debug', 2, 64, paged=True,
                                           block_k=8, step_chunk=2,
                                           device='cpu')
        server = model_server.ModelServer(engine, 0, host='127.0.0.1',
                                          default_max_new_tokens=3)
        port = server.start()
        status, _, _ = _post(port, {'prompt': [1, 2, 3], 'stream': False})
        assert status == 200
        alive = weakref.ref(engine)
        del engine
        server.stop()
        del server
        assert alive() is None
    finally:
        gc.enable()


def _paged_server(tparams, prefix_peers=None, port=0):
    engine = model_server.build_engine('debug', 2, 64, step_chunk=2,
                                       paged=True, block_k=8, device='cpu',
                                       params=tparams,
                                       prefix_peers=prefix_peers)
    server = model_server.ModelServer(engine, port, host='127.0.0.1',
                                      default_max_new_tokens=4)
    port = server.start()
    return server, engine, f'http://127.0.0.1:{port}'


def _http(url, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope='module')
def bridged():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     tllama.CONFIGS['debug'])


def test_cross_replica_prefix_fetch_http_e2e(bridged):
    """Two port replicas on localhost: B, cold, pulls A's cached prefix
    blocks through POST /prefix_blocks (served off A's engine loop) and
    answers A's tokens; the endpoint's contract; /slo's cache block; B's
    own address in its peers, under an alias only the instance-id echo
    can catch, is excluded for good."""
    from skypilot_tpu_torch.models import prefix_transfer
    shared = np.random.RandomState(3).randint(0, 256, size=24).tolist()
    srv_a = srv_b = None
    try:
        srv_a, _, url_a = _paged_server(
            bridged, prefix_peers=['http://peer-placeholder:1'])
        status, _ = _http(url_a, '/generate', {
            'prompt': shared + [1, 2, 3], 'max_new_tokens': 4,
            'stream': False})
        assert status == 200
        status, body = _http(url_a, '/prefix_blocks',
                             {'prompt': shared, 'from_tokens': 0})
        assert status == 200
        payload = prefix_transfer.decode_payload(body)
        assert payload['matched_tokens'] == len(shared)
        assert payload['arrays']['k'].shape[1] == len(shared) // 8
        status, body = _http(url_a, '/prefix_blocks', {'prompt': [9] * 24})
        assert status == 200 and body['arrays'] == {}
        assert body['matched_tokens'] == 0

        srv_b, eng_b, url_b = _paged_server(bridged,
                                            prefix_peers=['SELF', url_a])
        # An alias of B's own address that URL guessing cannot know
        # (the server registers 127.0.0.1 and localhost, not 0.0.0.0).
        self_alias = url_b.replace('127.0.0.1', '0.0.0.0')
        eng_b.prefix_peers[0] = self_alias
        prompt = shared + [5, 6, 7, 8]
        body = {'prompt': prompt, 'max_new_tokens': 6, 'stream': False}
        _, out_a = _http(url_a, '/generate', body)
        _, out_b = _http(url_b, '/generate', body)
        assert out_b['tokens'] == out_a['tokens']
        _, slo = _http(url_b, '/slo')
        assert slo['cache']['prefix_fetch_hits'] == 1
        assert slo['cache']['prefix_fetch_tokens'] == len(shared)
        assert slo['cache']['prefill_tokens_saved'] >= len(shared)
        assert slo['cache']['prefix_peers'] == 2
        assert self_alias in eng_b._prefix_self_urls  # pylint: disable=protected-access
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                srv.stop()


def test_prefix_blocks_refusals_and_journal_gate(bridged, monkeypatch):
    """/prefix_blocks answers as the reference's: 400 on an unpaged
    replica, 404 without peers, 400 on a malformed body, {"self": true}
    at once for the replica's own instance, GET 404 (no block store
    hosted); /journal opens to a replica that has peers."""
    monkeypatch.delenv(model_server.JOURNAL_PEERS_ENV, raising=False)
    servers = []
    try:
        dense = model_server.ModelServer(
            model_server.build_engine('debug', 1, 32, device='cpu',
                                      params=bridged), 0, host='127.0.0.1')
        servers.append(dense)
        url_dense = f'http://127.0.0.1:{dense.start()}'
        status, body = _http(url_dense, '/prefix_blocks', {'prompt': [1]})
        assert (status, body) == (400, {'error': 'replica is not paged'})
        srv, _, url = _paged_server(bridged)
        servers.append(srv)
        status, body = _http(url, '/prefix_blocks', {'prompt': [1]})
        assert status == 404 and 'SKYTPU_PREFIX_PEERS' in body['error']
        assert _http(url, '/journal')[0] == 404
        srv, eng, url = _paged_server(bridged, prefix_peers=['http://x:1'])
        servers.append(srv)
        for raw in (b'{not json', b'[1, 2]', b'{"from_tokens": 0}',
                    b'{"prompt": "ab"}',
                    b'{"prompt": [1], "budget_seconds": null}'):
            status, body = _http(url, '/prefix_blocks', raw=raw)
            assert status == 400 and 'needs "prompt"' in body['error'], raw
        t0 = time.perf_counter()
        status, body = _http(url, '/prefix_blocks', {
            'prompt': [1] * 16, 'instance': eng.instance_id})
        assert (status, body) == (200, {'self': True})
        assert time.perf_counter() - t0 < 1.0
        status, body = _http(url, '/prefix_blocks')
        assert (status, body) == (404,
                                  {'error': 'no block store hosted here'})
        status, body = _http(url, '/journal')
        assert status == 200 and body['role'] == 'mixed'
    finally:
        for srv in servers:
            srv.stop()


def test_prefix_peers_flag_reaches_the_engine(monkeypatch):
    """``--prefix-peers`` parses as the reference's CLI declares it
    (default None), and ``main()`` hands ``build_engine`` the list split
    at commas with blanks dropped; absent, None (the engine then reads
    SKYTPU_PREFIX_PEERS)."""
    assert model_server.parse_args([]).prefix_peers is None
    seen = []
    build = model_server.build_engine

    def fake_build(*a, **kw):
        seen.append(kw['prefix_peers'])
        return build('debug', 1, 32, device='cpu')

    monkeypatch.setattr(model_server, 'build_engine', fake_build)
    monkeypatch.setattr(model_server.ModelServer, 'run_forever',
                        lambda self: None)
    model_server.main(['--paged', '--prefix-peers',
                       'http://a:1, ,http://b:2,', '--device', 'cpu'])
    model_server.main(['--paged', '--device', 'cpu'])
    assert seen == [['http://a:1', 'http://b:2'], None]


def test_role_flag_reaches_the_server(monkeypatch):
    """``--role`` parses with the reference's choices (default None) and
    ``main()`` hands it to the server, which shows it; the argument wins
    over ``SKYTPU_REPLICA_ROLE``; the store role serves, hosting no store
    without ``SKYTPU_STORE_DIR``, as the reference's does."""
    assert model_server.parse_args([]).role is None
    seen = []
    monkeypatch.setattr(model_server.ModelServer, 'run_forever',
                        lambda self: seen.append(self.role))
    monkeypatch.setenv('SKYTPU_REPLICA_ROLE', 'decode')
    monkeypatch.delenv(block_store.STORE_DIR_ENV, raising=False)
    for role in ('prefill', 'decode', 'mixed', 'store'):
        model_server.main(['--role', role, '--device', 'cpu'])
    model_server.main(['--device', 'cpu'])
    assert seen == ['prefill', 'decode', 'mixed', 'store', 'decode']
    with pytest.raises(SystemExit):
        model_server.parse_args(['--role', 'leader'])
    srv = model_server.ModelServer(
        model_server.build_engine('debug', 1, 32, device='cpu'), 0,
        role='store')
    assert srv.role == 'store' and srv.store is None
    assert srv.slo()['store']['hosting'] is False


def test_store_flags_reach_main(monkeypatch, tmp_path):
    """``--store-url`` and ``--store-dir`` parse as the reference's CLI
    declares them (default None); ``main()`` hands ``build_engine`` the
    URL and the server a block store opened on the directory, whatever
    the role; absent, None (the engine then reads SKYTPU_STORE_URL, and
    only the store role reads SKYTPU_STORE_DIR)."""
    args = model_server.parse_args([])
    assert args.store_url is None and args.store_dir is None
    seen = []
    build = model_server.build_engine

    def fake_build(*a, **kw):
        seen.append(kw['store_url'])
        return build('debug', 1, 32, paged=True, block_k=8, device='cpu',
                     store_url=kw['store_url'])

    monkeypatch.setattr(model_server, 'build_engine', fake_build)
    monkeypatch.setattr(
        model_server.ModelServer, 'run_forever',
        lambda self: seen.append((self.role, self.store and self.store.root,
                                  self.engine.store_url)))
    store_dir = str(tmp_path / 'store')
    model_server.main(['--paged', '--store-url', 'http://s:1',
                       '--store-dir', store_dir, '--device', 'cpu'])
    model_server.main(['--paged', '--device', 'cpu'])
    monkeypatch.setenv(block_store.STORE_DIR_ENV, store_dir)
    model_server.main(['--role', 'store', '--device', 'cpu'])
    model_server.main(['--role', 'mixed', '--device', 'cpu'])
    assert seen == ['http://s:1', ('mixed', store_dir, 'http://s:1'),
                    None, ('mixed', None, None),
                    None, ('store', store_dir, None),
                    None, ('mixed', None, None)]
    assert os.path.isdir(store_dir)
