"""The port's serving telemetry against the JAX reference, on the ``debug``
config with the reference's weights bridged through numpy:

* metrics registry (skypilot_tpu_torch/observability/metrics.py): the
  same counter/gauge/histogram operations give a byte-identical
  ``generate_latest()``, and the same names, labels and buckets raise;
* request-telemetry plane (observability/request_trace.py): for the same
  fake requests, ``RequestTelemetry.snapshot()``/``slo()``, the
  slow-request payloads and the ``skytpu_request_*`` series equal the
  reference's (wall-clock fields masked); the step profiler's
  ``skytpu_engine_step_seconds``/``stalls_total``;
* the engine's wiring (models/engine.py): the reference's DecodeEngine
  and the port's take the same request sequence (paged with chunked
  prefill, clamp and reject; spec; a dense engine through one chaos
  crash): the journal's kinds with their payload keys, the
  ``engine.compile``/``engine.hbm``/``engine.mesh`` payloads, every
  ``skytpu_engine_*`` counter and gauge, ``cache_stats()``,
  ``handoff_stats()``, ``spec_stats()`` and the key set of ``slo()`` are
  equal, and the greedy tokens identical;
* the server (serve/model_server.py): ``/slo``, ``/debug/engine`` and
  ``/debug/requests`` carry the reference server's keys, recursively;
  ``/healthz`` names the role; ``X-Request-Id`` is minted when absent and
  answered as the trace id; ``/journal`` answers 404, or with
  ``SKYTPU_JOURNAL_PEERS`` the request's engine rows nested under its
  ``server.request`` span, itself under the caller's span;
* a wedged journal (``journal_write_stall``) never holds up ``step()``.
"""
import json
import os
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
from skypilot_tpu.observability import journal as rjournal
from skypilot_tpu.observability import metrics as rmetrics
from skypilot_tpu.observability import request_trace as rtrace
from skypilot_tpu.serve import model_server as rserver
from skypilot_tpu.utils import chaos as rchaos
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as tengine
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.observability import journal as tjournal
from skypilot_tpu_torch.observability import metrics as tmetrics
from skypilot_tpu_torch.observability import request_trace as ttrace
from skypilot_tpu_torch.serve import model_server as tserver
from skypilot_tpu_torch.utils import chaos as tchaos

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']
# Tie-free on this model (tests/test_torch_chunked_prefill.py).
MAX_NEWS = [4, 8, 3, 6, 8]
REF = (rmetrics, rtrace, rjournal, rchaos)
PORT = (tmetrics, ttrace, tjournal, tchaos)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in (tchaos.CHAOS_ENV, ttrace.SLOW_REQUEST_ENV,
                 ttrace.TTFT_SLO_ENV, ttrace.CAPACITY_ENV,
                 tserver.JOURNAL_PEERS_ENV, tjournal.DB_PATH_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(tengine.IDLE_SLEEP_ENV, '0.002')
    prev = [m.set_registry(m.MetricsRegistry()) for m in (rmetrics,
                                                          tmetrics)]
    rchaos.reset()
    tchaos.reset()
    yield
    rmetrics.set_registry(prev[0])
    tmetrics.set_registry(prev[1])
    rchaos.reset()
    tchaos.reset()


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


# ------------------------------------------------------------ registry


def _exercise(m):
    reg = m.get_registry()
    c = m.counter('skytpu_t_requests_total', 'Requests.\nWith "quotes"',
                  labels=('tenant', 'code'))
    c.inc(labels=('a', '200'))
    c.inc(2.5, labels=('b\\"x\n', '500'))
    g = m.gauge('skytpu_t_depth', 'Depth\\help.')
    g.set(3)
    g.dec(0.25)
    g2 = m.gauge('skytpu_t_by_url', 'Per url.', labels=('url',))
    g2.set(float('inf'), labels=('u1',))
    g2.set(float('nan'), labels=('u2',))
    g2.set(-7, labels=('u3',))
    g2.remove(labels=('u3',))
    h = m.histogram('skytpu_t_latency_seconds', 'Latency.',
                    labels=('tenant',), buckets=(0.1, 1.0, float('inf')))
    for v in (0.05, 0.1, 0.5, 3.0):
        h.observe(v, labels=('a',))
    m.histogram('skytpu_t_default_seconds').observe(1e-4)
    assert m.counter('skytpu_t_requests_total', labels=('tenant', 'code')
                     ) is c
    errors = []
    for bad in (lambda: m.counter('bad_name'),
                lambda: m.counter('skytpu_t_requests_total'),
                lambda: m.gauge('skytpu_t_depth2', labels=('trace_id',)),
                lambda: m.histogram('skytpu_t_latency_seconds',
                                    labels=('tenant',), buckets=(1.0,)),
                lambda: c.inc(-1, labels=('a', '200')),
                lambda: c.inc(labels=('a',))):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    return m.generate_latest(), reg.last_write_ts > 0, errors


def test_exposition_is_byte_identical_to_the_reference():
    got, want = _exercise(tmetrics), _exercise(rmetrics)
    assert got == want
    text = got[0].decode()
    assert 'skytpu_t_latency_seconds_bucket{tenant="a",le="+Inf"} 4' in text
    assert tmetrics.CONTENT_TYPE_LATEST == rmetrics.CONTENT_TYPE_LATEST
    assert tmetrics.UNBOUNDED_LABEL_NAMES == rmetrics.UNBOUNDED_LABEL_NAMES
    for v in (0.0, 1.5, 1e-7, 2.0**60, float('-inf')):
        assert tmetrics.format_float(v) == rmetrics.format_float(v)


# ----------------------------------------------------- request telemetry


class FakeReq:
    """Duck-typed engine Request: the attributes the plane reads (the
    reference test's pattern)."""

    def __init__(self, rid, prompt_len=4, max_new=8, tenant='default',
                 trace_id=None):
        self.id = rid
        self.tenant = tenant
        self.prompt = [1] * prompt_len
        self.max_new_tokens = max_new
        self.tokens = []
        self.enqueue_ts = None
        self.first_token_ts = None
        self.finish_ts = None
        self.finish_reason = None
        self.trace_id = trace_id


LIFECYCLES = [
    # (rid, tenant, stamps (enqueue, admit, first, finish), generated,
    #  reason)
    ('q0', 'acme', (1.0, 1.01, 1.03, 1.1), 5, 'length'),
    ('q1', 'acme', (1.0, 1.5, 2.5, 40.0), 30, 'eos'),
    ('q2', 'bravo', (2.0, None, None, 2.5), 0, 'rejected: prompt_too_long'),
    ('q3', 'bravo', (2.0, 2.1, None, 2.2), 0, 'error: engine crashed: x'),
    ('q4', 'acme', (3.0, 3.2, 3.9, 4.0), 1, 'length'),
    ('q5', 'default', (3.0, 3.1, 3.15, 3.3), 4, 'handoff'),
]


def _drive_plane(trace):
    plane = trace.RequestTelemetry(name='e')
    breaches = []
    for rid, tenant, (enq, adm, ftt, fin), gen, reason in LIFECYCLES:
        req = FakeReq(rid, tenant=tenant, trace_id=f't-{rid}')
        req.enqueue_ts = enq
        plane.on_enqueue(req)
        if adm is not None:
            plane.on_admit(req, slot=int(rid[1]) % 2, admit_ts=adm,
                           prefix_hit_tokens=8, blocks_reserved=2)
        req.first_token_ts = ftt
        req.tokens = list(range(gen))
        req.finish_ts = fin
        req.finish_reason = reason
        breaches.append(plane.on_finish(req, reason))
    queued = FakeReq('q9', trace_id='t-q9')
    queued.enqueue_ts = time.perf_counter()
    plane.on_enqueue(queued)
    return plane, breaches


def _mask(obj):
    """Drop the wall-clock fields (stamped with time.time() or the live
    perf_counter) from a snapshot/slo body."""
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items()
                if k not in ('enqueue_unix_ts', 'span_seconds',
                             'age_seconds', 'queue_wait')}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


@pytest.mark.parametrize('env', [{}, {'SKYTPU_SLOW_REQUEST_SECONDS': '0.5',
                                      'SKYTPU_TTFT_SLO_SECONDS': '0.8',
                                      'SKYTPU_REQUEST_TRACE_CAPACITY': '4'}])
def test_request_telemetry_matches_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tplane, tbreach = _drive_plane(ttrace)
    rplane, rbreach = _drive_plane(rtrace)
    assert tbreach == rbreach
    assert _mask(tplane.snapshot()) == _mask(rplane.snapshot())
    assert _mask(tplane.snapshot(2)) == _mask(rplane.snapshot(2))
    # queue_wait of a completed record is exact: compare it there.
    assert ([r['phases'] for r in tplane.snapshot()['completed']] ==
            [r['phases'] for r in rplane.snapshot()['completed']])
    assert _mask(tplane.slo()) == _mask(rplane.slo())
    assert tmetrics.generate_latest() == rmetrics.generate_latest()
    if env:
        assert tplane.capacity == 4
        assert sum(b is not None for b in tbreach) == 3
        assert tplane.slo()['rates']['slow_total'] == 3
        assert tbreach[4]['breached'] == ['total', 'ttft']
    else:
        assert tbreach[1] is not None and tbreach[1]['breached'] == ['total']
    for values in ([], [3.0], [1.0, 2.0, 10.0, 4.0]):
        assert ttrace.percentiles(values) == rtrace.percentiles(values)
    for reason in (None, 'eos', 'length', 'rejected: x', 'error: y', 'z'):
        assert ttrace._reason_class(reason) == rtrace._reason_class(reason)  # pylint: disable=protected-access


def test_step_profiler_metrics_match_the_reference():
    """The same step times give the same skytpu_engine_step_seconds
    histogram, stall payloads and skytpu_engine_stalls_total."""
    steps = [0.01] * 10 + [0.5, 0.01, 0.02, 1.5]
    out = []
    for trace, m in ((ttrace, tmetrics), (rtrace, rmetrics)):
        prof = trace.EngineStepProfiler(name='e')
        stalls = [prof.record(s, chunk=2, active=3, delivered=6,
                              queue_depth=1, prefill_tokens=i % 3)
                  for i, s in enumerate(steps)]
        snap = prof.snapshot(last_n=0)
        snap.pop('last_step_age_seconds')
        out.append((stalls, snap, m.generate_latest()))
    assert out[0] == out[1]
    assert sum(s is not None for s in out[0][0]) == 2


# ---------------------------------------------------------------- engine


def _prompts(seed=3, prefix_len=16, extras=(3, 7, 0, 5, 9)):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG.vocab_size, size=prefix_len).tolist()
    return [shared + rng.randint(0, CFG.vocab_size, size=int(e)).tolist()
            for e in extras]


def _build(side, params, db, paged, spec_k=0, prefill_chunk=0):
    kw = dict(max_len=64, kernel_block_k=8, spec_k=spec_k,
              spec_drafter_layers=1)
    if side == 'ref':
        return jengine.DecodeEngine(
            params, JCFG, jdecode.DecodeConfig(decode_attention='xla', **kw),
            2, step_chunk=2, prefill_buckets=(16, 32), paged=paged,
            num_blocks=40 if paged else None, prefill_chunk=prefill_chunk,
            name='tele', journal_db=db)
    return tengine.DecodeEngine(
        params, CFG, tdecode.DecodeConfig(**kw), 2, step_chunk=2,
        prefill_buckets=(16, 32), paged=paged,
        num_blocks=40 if paged else None, prefill_chunk=prefill_chunk,
        name='tele', journal_db=db)


def _requests(mod, case):
    prompts = _prompts()
    # Explicit ids: each package's counter of request ids runs on with
    # the other tests of the process.
    reqs = [mod.Request(p, m, request_id=f'q{i}', trace_id=f'tr{i}',
                        span_id=f'sp{i}')
            for i, (p, m) in enumerate(zip(prompts, MAX_NEWS))]
    if case == 'paged':
        rng = np.random.RandomState(9)
        # Clamped to 4 new tokens (prompt 60 of max_len 64), then one
        # whose prompt alone overflows max_len.
        reqs.append(mod.Request(
            rng.randint(0, CFG.vocab_size, size=60).tolist(), 8,
            request_id='qc', tenant='other', trace_id='trc'))
        reqs.append(mod.Request(list(range(70)), 4, request_id='qr',
                                trace_id='trr'))
    return reqs


def _drive(eng, reqs, chaos, crash_after=None):
    """Submit everything and step until done; with ``crash_after``, arm
    one engine_step_raise after that many steps and run the supervisor's
    recovery as run_forever would."""
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        if steps == crash_after:
            os.environ[chaos.CHAOS_ENV] = 'engine_step_raise:1'
        try:
            eng.step()
        except chaos.ChaosError as exc:
            assert eng._recover_from_crash(exc)  # pylint: disable=protected-access
            del os.environ[chaos.CHAOS_ENV]
        steps += 1
        assert steps < 500, 'engine did not converge'
    eng.flush_journal()


def _series(m, kinds):
    """Sample lines of the engine/request series (histograms: their
    _count lines, whose values are host times otherwise)."""
    out = {}
    for metric in m.get_registry().metrics():
        if metric.kind not in kinds or not metric.name.startswith(
                ('skytpu_engine_', 'skytpu_request_')):
            continue
        lines = metric.expose()[2:]
        if metric.kind == 'histogram':
            lines = [ln for ln in lines if '_count' in ln]
        out[metric.name] = lines
    return out


CASES = {'paged': dict(paged=True, prefill_chunk=8),
         'spec': dict(paged=True, spec_k=2),
         'crash': dict(paged=False)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_engine_journal_and_counters_match_the_reference(params, tmp_path,
                                                         case):
    jp, tp = params
    runs = {}
    for side, p, mod, (m, _, jrn, chaos) in (('ref', jp, jengine, REF),
                                              ('port', tp, tengine, PORT)):
        m.set_registry(m.MetricsRegistry())
        db = str(tmp_path / f'{side}.db')
        eng = _build(side, p, db, **CASES[case])
        reqs = _requests(mod, case)
        _drive(eng, reqs, chaos, crash_after=2 if case == 'crash' else None)
        rows = rjournal.query(db_path=db, limit=10000, ascending=True)
        runs[side] = dict(
            eng=eng, reqs=reqs, rows=rows,
            seq=[(r['kind'], sorted(r['payload']), r['trace_id'],
                  r['span_id']) for r in rows],
            shapes=[r['payload'] for r in rows
                    if r['kind'] in ('engine.compile', 'engine.mesh',
                                     'engine.hbm', 'engine.reject')],
            counters=_series(m, ('counter',)),
            gauges=_series(m, ('gauge',)),
            hists=_series(m, ('histogram',)))
    ref, port = runs['ref'], runs['port']
    for r, t in zip(ref['reqs'], port['reqs']):
        assert (t.tokens, t.finish_reason) == (r.tokens, r.finish_reason)
    assert port['seq'] == ref['seq']
    assert port['shapes'] == ref['shapes']
    # The occupancy gauge is published at each eviction. The reference
    # counts a round's steps after its deliveries, so its gauge can read
    # the round's tokens over the steps before it (above 1 here); the
    # port counts them first. The final occupancy is equal.
    for side in (port, ref):
        side['gauges'].pop('skytpu_engine_slot_occupancy')
    for key in ('counters', 'gauges', 'hists'):
        assert port[key] == ref[key], key
    te, re_ = port['eng'], ref['eng']
    assert te.mean_occupancy() == re_.mean_occupancy()
    assert te.cache_stats() == re_.cache_stats()
    assert te.handoff_stats() == re_.handoff_stats()
    assert te.spec_stats() == re_.spec_stats()
    assert set(te.telemetry.slo()) == set(re_.telemetry.slo())
    assert _mask(te.telemetry.slo()['rates']) == _mask(
        re_.telemetry.slo()['rates'])
    assert set(re_.stats()) <= set(te.stats())
    kinds = [s[0] for s in port['seq']]
    assert kinds.count('engine.compile') == len(te._traced_shapes)  # pylint: disable=protected-access
    assert port['counters']['skytpu_engine_compiles_total'] == [
        f'skytpu_engine_compiles_total {kinds.count("engine.compile")}']
    if case == 'crash':
        assert kinds.count('engine.crash') == kinds.count(
            'engine.restart') == 1
        assert any((r.finish_reason or '').startswith('error: engine '
                                                      'crashed')
                   for r in port['reqs'])
    elif case == 'spec':
        assert te.spec_stats()['drafted_total'] > 0
    else:
        assert {'clamp', 'reject'} <= {
            r['payload'].get('action') for r in port['rows']
            if r['kind'] == 'engine.reject'}
        assert te.spec_stats()['chunked_admissions'] > 0


def test_step_never_waits_on_a_wedged_journal(params, tmp_path,
                                              monkeypatch):
    """journal_write_stall armed: every step() returns within a tick
    while the flush thread sleeps; once the chaos is off, one
    journal.stall row lands."""
    _, tp = params
    monkeypatch.setenv(tchaos.JOURNAL_STALL_SECONDS_ENV, '1.5')
    monkeypatch.setenv(tjournal.STALL_SECONDS_ENV, '1.0')
    db = str(tmp_path / 'j.db')
    eng = _build('port', tp, db, paged=True)
    monkeypatch.setenv(tchaos.CHAOS_ENV, 'journal_write_stall')
    reqs = [tengine.Request(p, 8) for p in _prompts()[:2]]
    for r in reqs:
        eng.submit(r)
    times = []
    while not all(r.done for r in reqs):
        t0 = time.perf_counter()
        eng.step()
        times.append(time.perf_counter() - t0)
    assert max(times) < 1.0, times
    monkeypatch.delenv(tchaos.CHAOS_ENV)
    eng.flush_journal()
    eng.flush_journal()
    eng._jbuf.append('engine.stall', 'engine:tele', {})  # pylint: disable=protected-access
    eng.flush_journal()
    kinds = [r['kind'] for r in rjournal.query(db_path=db, limit=1000)]
    assert kinds.count('journal.stall') == 1
    assert kinds.count('engine.evict') == 2


# ---------------------------------------------------------------- server


def _http(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _keys(obj):
    """The key tree of a JSON body: dicts by key, lists by their first
    element."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


def _contains(big, small, path=''):
    """Every key of ``small`` is in ``big``, recursively."""
    if isinstance(small, dict):
        assert isinstance(big, dict), path
        for k, v in small.items():
            assert k in big, f'{path}/{k}'
            _contains(big[k], v, f'{path}/{k}')
    elif isinstance(small, list) and small:
        assert big, path
        _contains(big[0], small[0], path + '[0]')


@pytest.fixture(scope='module')
def servers(params, tmp_path_factory):
    """The reference's and the port's replica on the same weights, each
    with its own journal file; both answer the same three requests."""
    jp, tp = params
    d = tmp_path_factory.mktemp('servers')
    jeng = jengine.DecodeEngine(
        jp, JCFG, jdecode.DecodeConfig(max_len=64, kernel_block_k=8,
                                       decode_attention='xla'),
        2, step_chunk=2, prefill_buckets=(16, 32), paged=True,
        num_blocks=40, name='srv', journal_db=str(d / 'ref.db'))
    teng = tengine.DecodeEngine(
        tp, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=8),
        2, step_chunk=2, prefill_buckets=(16, 32), paged=True,
        num_blocks=40, name='srv', journal_db=str(d / 'port.db'))
    out = {}
    for side, mod, eng in (('ref', rserver, jeng), ('port', tserver, teng)):
        srv = mod.ModelServer(eng, 0, host='127.0.0.1')
        out[side] = (srv, srv.start())
    prompts = _prompts()
    for side, (_, port) in out.items():
        for i, p in enumerate(prompts[:3]):
            status, _, _ = _http(port, '/generate',
                                 {'prompt': p, 'max_new_tokens': MAX_NEWS[i],
                                  'stream': i % 2 == 0})
            assert status == 200, side
    yield {side: port for side, (_, port) in out.items()}
    for srv, _ in out.values():
        srv.stop()


@pytest.mark.parametrize('path', ['/slo', '/debug/engine?n=4',
                                  '/debug/requests?n=2'])
def test_bodies_have_the_reference_servers_keys(servers, path):
    bodies = {}
    for side, port in servers.items():
        status, _, text = _http(port, path)
        assert status == 200
        bodies[side] = json.loads(text)
    ref, port = _keys(bodies['ref']), _keys(bodies['port'])
    _contains(port, ref)
    if path == '/slo':
        assert port == ref
        for side in ('ref', 'port'):
            assert bodies[side]['window']['completed'] == 3
            assert bodies[side]['role'] == 'mixed'
        assert bodies['port']['spec'] == bodies['ref']['spec']
        assert bodies['port']['cache'] == bodies['ref']['cache']
        assert bodies['port']['handoff'] == bodies['ref']['handoff']
    elif path.startswith('/debug/requests'):
        assert port == ref
        assert len(bodies['port']['completed']) == 2
    else:
        assert port['step_profile'] == ref['step_profile']
        assert bodies['port']['step_profile']['steps_recorded'] > 0


def test_healthz_names_the_role_and_metrics_expose_the_engine(servers):
    for side, port in servers.items():
        status, _, text = _http(port, '/healthz')
        assert status == 200, side
        assert text.startswith('ok staleness_seconds=')
        assert text.split()[2] == 'role=mixed', text
    port = servers['port']
    for stream in (True, False):
        _http(port, '/generate', {'prompt': [2, 7, 1], 'max_new_tokens': 3,
                                  'stream': stream})
    status, headers, text = _http(port, '/metrics')
    assert status == 200
    assert headers['Content-Type'] == 'text/plain; charset=utf-8'
    for line in ('skytpu_engine_admitted_total 2',
                 'skytpu_engine_evicted_total 2',
                 'skytpu_engine_tokens_total 6',
                 'skytpu_engine_ttft_seconds_count 2',
                 'skytpu_request_ttft_seconds_count{tenant="default"} 2',
                 'skytpu_engine_requests_total{stream="true"} 1',
                 'skytpu_engine_requests_total{stream="false"} 1',
                 '# TYPE skytpu_engine_step_seconds histogram'):
        assert line in text, line


@pytest.mark.parametrize('stream', [False, True])
def test_request_id_is_minted_and_answered_as_the_trace_id(servers, stream):
    port = servers['port']
    body = {'prompt': [3, 1, 4], 'max_new_tokens': 2, 'stream': stream}
    _, headers, _ = _http(port, '/generate', body)
    minted = headers['X-Request-Id']
    assert len(minted) == 32 and int(minted, 16) >= 0
    assert not minted.startswith('r')
    _, headers, _ = _http(port, '/generate', body,
                          {'X-Request-Id': 'client-7'})
    assert headers['X-Request-Id'] == 'client-7'
    _, headers, _ = _http(port, '/generate', body,
                          {'X-Request-Id': 'client-8',
                           'X-Skytpu-Trace-Id': 'lb-trace'})
    assert headers['X-Request-Id'] == 'lb-trace'
    status, _, text = _http(port, '/debug/requests?n=3')
    traces = {r['trace_id'] for r in json.loads(text)['completed']}
    assert {minted, 'client-7', 'lb-trace'} <= traces


def test_journal_query_plane(servers, monkeypatch):
    """404 without SKYTPU_JOURNAL_PEERS; with it, one trace's rows: the
    server.request span under the caller's span, the engine's admit and
    evict under the server span."""
    port = servers['port']
    status, _, _ = _http(port, '/journal')
    assert status == 404
    _http(port, '/generate', {'prompt': [5, 6, 7], 'max_new_tokens': 2,
                              'stream': False},
          {'X-Request-Id': 'trace-j', 'X-Skytpu-Span-Id': 'lbspan'})
    monkeypatch.setenv(tserver.JOURNAL_PEERS_ENV, 'http://head:1')
    for method_body in (None, {'trace_id': 'trace-j'}):
        path = '/journal' if method_body else '/journal?trace_id=trace-j'
        status, _, text = _http(port, path, method_body)
        assert status == 200
        out = json.loads(text)
        assert out['role'] == 'mixed' and out['host'].startswith('server:')
        rows = out['events']
        kinds = [r['kind'] for r in rows]
        assert kinds == ['span.start', 'engine.admit', 'engine.evict',
                         'span.end'], kinds
        span = rows[0]['span_id']
        assert rows[0]['parent_span_id'] == 'lbspan'
        assert all(r['trace_id'] == 'trace-j' for r in rows)
        assert all(r['span_id'] == span for r in rows)
        assert rows[0]['payload']['name'] == 'server.request'
    status, _, text = _http(port, '/journal', {'kinds': 'engine.hbm'})
    assert [r['kind'] for r in json.loads(text)['events']] == ['engine.hbm']


def test_telemetry_knobs_are_read_not_refused(params, tmp_path, monkeypatch):
    """SKYTPU_JOURNAL_PEERS, SKYTPU_SLOW_REQUEST_SECONDS,
    SKYTPU_TTFT_SLO_SECONDS and SKYTPU_REQUEST_TRACE_CAPACITY: a replica
    starts with them set and reads each; a breach journals
    engine.slow_request under the request's trace id."""
    _, tp = params
    monkeypatch.setenv(tserver.JOURNAL_PEERS_ENV, 'http://head:1')
    monkeypatch.setenv(ttrace.SLOW_REQUEST_ENV, '1e-6')
    monkeypatch.setenv(ttrace.TTFT_SLO_ENV, '1e-6')
    monkeypatch.setenv(ttrace.CAPACITY_ENV, '2')
    monkeypatch.setenv(tjournal.DB_PATH_ENV, str(tmp_path / 'env.db'))
    eng = tserver.build_engine('debug', 2, 64, step_chunk=2, device='cpu',
                               params=tp, paged=True, block_k=8)
    assert eng.telemetry.capacity == 2
    srv = tserver.ModelServer(eng, 0, host='127.0.0.1')
    port = srv.start()
    try:
        for i in range(3):
            _http(port, '/generate', {'prompt': [1, 2, 3 + i],
                                      'max_new_tokens': 2, 'stream': False},
                  {'X-Request-Id': f'slow-{i}'})
        _, _, text = _http(port, '/slo')
        slo = json.loads(text)
        assert slo['window'] == {**slo['window'], 'capacity': 2,
                                 'completed': 2}
        assert slo['rates']['slow_total'] == 3
        assert slo['slo'] == {'slow_request_seconds': 1e-6,
                              'ttft_slo_seconds': 1e-6}
        status, _, text = _http(port, '/journal',
                                {'trace_id': 'slow-1',
                                 'kinds': 'engine.slow_request'})
        rows = json.loads(text)['events']
        assert status == 200 and len(rows) == 1
        assert rows[0]['payload']['breached'] == ['total', 'ttft']
    finally:
        srv.stop()
    assert os.path.exists(tmp_path / 'env.db')


def test_backpressure_and_drain_are_recorded(params, tmp_path,
                                           monkeypatch):
    """A 429 counts skytpu_server_rejected_total; a drain journals its
    begin and done rows and moves skytpu_server_state to 2."""
    _, tp = params
    monkeypatch.setenv('SKYTPU_SERVE_MAX_QUEUE', '1')
    db = str(tmp_path / 'j.db')
    eng = _build('port', tp, db, paged=True)
    srv = tserver.ModelServer(eng, 0, host='127.0.0.1')
    port = srv.start()
    try:
        with monkeypatch.context() as m:
            m.setattr(eng, 'queue_depth', lambda: 1)
            status, _, _ = _http(port, '/generate', {'prompt': [1]})
        assert status == 429
        gauge = tmetrics.get_registry().get('skytpu_server_state')
        assert gauge.value() == 0
        status, _, _ = _http(port, '/drain', {})
        assert status == 202
        deadline = time.time() + 30
        while srv.state != 'stopped' and time.time() < deadline:
            time.sleep(0.01)
        assert srv.state == 'stopped'
    finally:
        srv.stop()
    assert gauge.value() == 2
    assert tmetrics.get_registry().get(
        'skytpu_server_rejected_total').value() == 1
    rows = rjournal.query(db_path=db, kinds=['server.drain'],
                          ascending=True)
    assert [r['payload']['phase'] for r in rows] == ['begin', 'done']
    assert rows[0]['payload']['reason'] == 'http'
    assert rows[1]['payload']['drained'] is True
