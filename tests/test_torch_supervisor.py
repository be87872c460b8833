"""Port supervision (skypilot_tpu_torch/models/engine.py ``run_forever``
and ``_recover_from_crash``, skypilot_tpu_torch/serve/model_server.py's
lifecycle) and its chaos harness (skypilot_tpu_torch/utils/chaos.py), on
a CPU engine with the reference's ``debug`` weights bridged through
numpy. Mirrors tests/unit_tests/test_chaos_supervisor.py,
tests/test_chaos.py (engine crash, restart budget, drain, drain_hang,
replica_500) and tests/test_model_server.py (429 backpressure, /healthz
staleness).

Tokens served after a restart are held to the reference's static
``generate`` on the same weights.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.utils import chaos

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.setenv(engine_lib.IDLE_SLEEP_ENV, '0.002')
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope='module')
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


def _reference(jparams, prompt, n):
    out = jdecode.generate(jparams, jnp.asarray([prompt], jnp.int32),
                           jnp.asarray([len(prompt)], jnp.int32), JCFG,
                           jdecode.DecodeConfig(max_len=64), n)
    return np.asarray(out)[0].tolist()


def _engine(tparams, num_slots=2, step_chunk=2, paged=False, **kwargs):
    dcfg = tdecode.DecodeConfig(max_len=64, kernel_block_k=8)
    return engine_lib.DecodeEngine(tparams, CFG, dcfg, num_slots,
                                   step_chunk=step_chunk,
                                   prefill_buckets=(16, 32), paged=paged,
                                   **kwargs)


def _run(eng):
    stop = threading.Event()
    thread = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    thread.start()
    return stop, thread


def _join(stop, thread):
    stop.set()
    thread.join(10)
    assert not thread.is_alive()


# ------------------------------------------------------------ chaos spec


def test_chaos_spec_parsing(monkeypatch):
    """Disarmed by default; counted specs fire exactly n times and re-arm
    on a new arg; probabilistic and bare specs; malformed specs are
    ignored (the reference's firing rules)."""
    assert not chaos.armed('engine_step_raise')
    chaos.maybe_raise('engine_step_raise')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:2')
    assert chaos.should_fire('engine_step_raise')
    assert chaos.should_fire('engine_step_raise')
    assert not chaos.should_fire('engine_step_raise')
    assert chaos.armed('engine_step_raise')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:3')
    with pytest.raises(chaos.ChaosError):
        chaos.maybe_raise('engine_step_raise')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'replica_500:1.0,drain_hang')
    assert all(chaos.should_fire('replica_500') for _ in range(20))
    assert all(chaos.should_fire('drain_hang') for _ in range(3))
    monkeypatch.setenv(chaos.CHAOS_ENV, 'replica_500:0.0')
    assert not any(chaos.should_fire('replica_500') for _ in range(20))
    assert not chaos.armed('drain_hang')
    monkeypatch.setenv(chaos.CHAOS_ENV, ' , :5, bogus:xyz ,slow_step:nan')
    assert not chaos.should_fire('bogus')
    assert not chaos.should_fire('slow_step')
    chaos.maybe_slow_step()


def test_slow_step_chaos_delays_engine_step(params, monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, 'slow_step:1.0')
    monkeypatch.setenv(chaos.SLOW_STEP_SECONDS_ENV, '0.08')
    eng = _engine(params[1])
    eng.submit(engine_lib.Request([1, 2, 3], 2))
    t0 = time.perf_counter()
    eng.step()
    assert time.perf_counter() - t0 >= 0.08


# ------------------------------------------------------------ supervisor


@pytest.mark.parametrize('paged', [False, True])
def test_crash_restarts_and_queued_requests_give_reference_tokens(
        params, monkeypatch, paged):
    """A step crash mid-decode fails the in-flight request at once (an
    error finish, not a timeout), rebuilds the cache and restarts; the
    queued requests survive and give the reference's tokens."""
    jp, tp = params
    eng = _engine(tp, num_slots=1, paged=paged)
    rng = np.random.RandomState(4)
    in_flight = engine_lib.Request(rng.randint(0, 256, 5).tolist(), 30)
    queued = [engine_lib.Request(rng.randint(0, 256, n).tolist(), 6)
              for n in (9, 3)]
    eng.submit(in_flight)
    eng.step()                            # admits in_flight, decodes
    assert eng.active_slots() == 1
    for r in queued:
        eng.submit(r)                     # no free slot: queued
    if paged:
        assert eng.stats()['blocks_used'] > 0
    monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:1')
    stop, thread = _run(eng)
    try:
        assert in_flight.wait(30)
        assert in_flight.finish_reason.startswith('error: engine crashed')
        assert 1 <= len(in_flight.tokens) < 30
        for r in queued:
            assert r.wait(30)
    finally:
        _join(stop, thread)
    for r in queued:
        assert r.finish_reason == 'length'
        assert r.tokens == _reference(jp, r.prompt, 6)
    stats = eng.stats()
    assert stats['restarts'] == eng.restart_count() == 1
    assert not stats['failed']
    if paged:
        # Only the queued requests ever used the rebuilt pool; after
        # their eviction the prefix cache holds their published blocks.
        assert stats['blocks_used'] == stats['prefix_cache_blocks']


def test_crash_during_chunked_admission_returns_the_pool(params,
                                                         monkeypatch):
    """A crash while a long prompt is mid-chunked-prefill fails it and
    rebuilds the pool: the allocator is back to empty."""
    _, tp = params
    eng = _engine(tp, paged=True, num_blocks=20, prefill_chunk=8)
    decoding = engine_lib.Request([5, 6, 7], 40)
    eng.submit(decoding)
    eng.step()
    long = engine_lib.Request(list(range(40, 70)), 4)
    eng.submit(long)
    eng.step()                            # parks it, runs its first chunk
    slot = eng._slots.index(long)  # pylint: disable=protected-access
    assert eng._prefill_state[slot]['next'] == 8  # pylint: disable=protected-access
    assert eng.stats()['chunked_admissions'] == 1
    assert eng.stats()['blocks_used'] > 0
    monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:1')
    stop, thread = _run(eng)
    try:
        assert long.wait(30) and decoding.wait(30)
        deadline = time.time() + 10
        while eng.restart_count() == 0 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        _join(stop, thread)
    assert long.finish_reason.startswith('error: engine crashed')
    assert long.tokens == []
    assert decoding.finish_reason.startswith('error: engine crashed')
    assert eng.restart_count() == 1
    assert eng._allocator.used() == 0  # pylint: disable=protected-access
    assert eng._prefill_state == [None, None]  # pylint: disable=protected-access
    assert eng.active_slots() == 0


def test_admission_crash_answers_the_request(params, monkeypatch):
    """A crash inside insert() finishes the popped request as an error
    before the exception reaches the supervisor."""
    eng = _engine(params[1], num_slots=1)
    req = engine_lib.Request([1, 2, 3], 4)
    eng.submit(req)
    boom = RuntimeError('device fell over')
    monkeypatch.setattr(eng, 'insert',
                        lambda *a, **k: (_ for _ in ()).throw(boom))
    with pytest.raises(RuntimeError, match='device fell over'):
        eng.step()
    assert req.done
    assert req.finish_reason == 'error: admission crashed: device fell over'
    assert eng.idle()


def test_restart_budget_exhausted_fails_permanently(params, monkeypatch):
    """Past SKYTPU_ENGINE_MAX_RESTARTS crashes in the window the loop
    ends on its own, the queued request is failed (not stranded), and a
    later submit is failed at once."""
    monkeypatch.setenv(engine_lib.MAX_RESTARTS_ENV, '1')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:5')
    eng = _engine(params[1], num_slots=1)
    req = engine_lib.Request([5, 6, 7], 4)
    eng.submit(req)
    stop, thread = _run(eng)
    thread.join(30)
    assert not thread.is_alive(), 'supervised loop did not give up'
    stop.set()
    assert eng.failed and 'crashes within' in eng.fail_reason
    assert eng.restart_count() == 1
    assert req.finish_reason == 'error: engine failed permanently'
    late = eng.submit(engine_lib.Request([1], 2))
    assert late.finish_reason == 'error: engine failed permanently'
    assert eng.stats()['failed'] is True


def test_restart_window_forgets_old_crashes(params, monkeypatch):
    """Crashes older than SKYTPU_ENGINE_RESTART_WINDOW_SECONDS leave the
    budget: with budget 1, two crashes further apart than the window
    both restart."""
    monkeypatch.setenv(engine_lib.MAX_RESTARTS_ENV, '1')
    monkeypatch.setenv(engine_lib.RESTART_WINDOW_ENV, '0.05')
    eng = _engine(params[1], num_slots=1)
    for _ in range(2):
        assert eng._recover_from_crash(RuntimeError('x'))  # pylint: disable=protected-access
        time.sleep(0.1)
    monkeypatch.setenv(engine_lib.RESTART_WINDOW_ENV, '300')
    assert not eng._recover_from_crash(RuntimeError('x'))  # pylint: disable=protected-access
    assert eng.restart_count() == 2 and eng.failed


# ----------------------------------------------------------- HTTP server


def _serve(tparams, **kwargs):
    eng = _engine(tparams, **kwargs)
    srv = model_server.ModelServer(eng, 0, host='127.0.0.1')
    return srv, eng, srv.start()


def _request(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_engine_crash_mid_decode_answers_500_and_recovers(params,
                                                          monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, 'slow_step:1.0')
    monkeypatch.setenv(chaos.SLOW_STEP_SECONDS_ENV, '0.05')
    jp, tp = params
    srv, eng, port = _serve(tp, step_chunk=1)
    try:
        result = {}
        thread = threading.Thread(target=lambda: result.update(r=_request(
            port, '/generate', {'prompt': [3, 1, 4], 'max_new_tokens': 40,
                                'stream': False})), daemon=True)
        thread.start()
        deadline = time.time() + 20
        while eng.active_slots() == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.active_slots() == 1
        time.sleep(0.2)                   # a few slowed steps in
        t0 = time.time()
        monkeypatch.setenv(chaos.CHAOS_ENV,
                           'slow_step:1.0,engine_step_raise:1')
        thread.join(30)
        assert not thread.is_alive()
        assert time.time() - t0 < 20      # fail-fast, not a timeout
        status, _, text = result['r']
        assert status == 500, text
        body = json.loads(text)
        assert 'engine crashed' in body['error'] and body['generated'] >= 1
        monkeypatch.setenv(chaos.CHAOS_ENV, '')
        status, _, text = _request(port, '/generate',
                                   {'prompt': [7, 8, 9],
                                    'max_new_tokens': 4, 'stream': False})
        assert status == 200
        assert json.loads(text)['tokens'] == _reference(jp, [7, 8, 9], 4)
        status, _, text = _request(port, '/healthz')
        assert status == 200 and text.startswith('ok staleness_seconds=')
        assert 'restarts=1' in text and 'failed=False' in text
    finally:
        srv.stop()


def test_restart_budget_exhaustion_is_permanent_503(params, monkeypatch):
    monkeypatch.setenv(engine_lib.MAX_RESTARTS_ENV, '0')
    srv, eng, port = _serve(params[1], num_slots=1)
    try:
        monkeypatch.setenv(chaos.CHAOS_ENV, 'engine_step_raise:3')
        t0 = time.time()
        status, _, _ = _request(port, '/generate',
                                {'prompt': [1, 2], 'max_new_tokens': 4,
                                 'stream': False})
        # Queued then failed (500), or refused at the door (503).
        assert status in (500, 503) and time.time() - t0 < 30
        deadline = time.time() + 15
        while not eng.failed and time.time() < deadline:
            time.sleep(0.02)
        assert eng.failed
        for _ in range(2):                # permanent: never clears
            status, _, text = _request(port, '/healthz')
            assert status == 503
            assert text.startswith('engine failed permanently')
        status, headers, text = _request(port, '/generate',
                                         {'prompt': [1], 'stream': False})
        assert status == 503 and headers['Retry-After'] == '30'
        assert 'engine failed' in json.loads(text)['error']
    finally:
        srv.stop()


def test_queue_backpressure_returns_429(params, monkeypatch):
    monkeypatch.setenv(model_server.MAX_QUEUE_ENV, '1')
    # A long idle wait parks the loop, so a queued request stays queued.
    monkeypatch.setenv(engine_lib.IDLE_SLEEP_ENV, '5')
    srv, eng, port = _serve(params[1], num_slots=1)
    assert srv.max_queue == 1
    try:
        time.sleep(0.3)
        eng.submit(engine_lib.Request([1, 2], 1))    # depth == max_queue
        status, headers, text = _request(port, '/generate',
                                         {'prompt': [1, 2, 3],
                                          'stream': False})
        assert status == 429 and headers['Retry-After'] == '1'
        assert 'queue full' in json.loads(text)['error']
    finally:
        srv.stop()


def test_drain_under_load_finishes_in_flight(params, monkeypatch):
    """POST /drain under load: the in-flight stream completes, new
    /generate calls get 503 + Retry-After, /healthz 503 'draining', and
    the server stops by itself."""
    monkeypatch.setenv(model_server.DRAIN_TIMEOUT_ENV, '25')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'slow_step:1.0')
    monkeypatch.setenv(chaos.SLOW_STEP_SECONDS_ENV, '0.05')
    jp, tp = params
    srv, eng, port = _serve(tp, step_chunk=1)
    try:
        result = {}
        thread = threading.Thread(target=lambda: result.update(r=_request(
            port, '/generate', {'prompt': [3, 1, 4],
                                'max_new_tokens': 20})), daemon=True)
        thread.start()
        deadline = time.time() + 20
        while eng.active_slots() == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.active_slots() == 1
        status, _, text = _request(port, '/drain', {})
        assert status == 202 and json.loads(text)['state'] == 'draining'
        status, headers, text = _request(port, '/generate',
                                         {'prompt': [5], 'stream': False})
        assert status == 503 and headers['Retry-After'] == '1'
        assert 'draining' in json.loads(text)['error']
        status, _, text = _request(port, '/healthz')
        assert status == 503 and text.startswith('draining')
        thread.join(60)
        assert not thread.is_alive(), 'in-flight stream cut by drain'
        events = [json.loads(line[len('data: '):])
                  for line in result['r'][2].splitlines()
                  if line.startswith('data: ')]
        assert [e['token'] for e in events] == _reference(jp, [3, 1, 4], 20)
        assert events[-1]['finish_reason'] == 'length'
        deadline = time.time() + 20
        while srv.state != 'stopped' and time.time() < deadline:
            time.sleep(0.05)
        assert srv.state == 'stopped'
        with pytest.raises(OSError):
            _request(port, '/healthz', timeout=2)
    finally:
        srv.stop()


def test_drain_hang_chaos_rides_out_the_timeout(params, monkeypatch):
    monkeypatch.setenv(model_server.DRAIN_TIMEOUT_ENV, '0.4')
    monkeypatch.setenv(chaos.CHAOS_ENV, 'drain_hang')
    srv, _, _ = _serve(params[1])
    try:
        t0 = time.time()
        assert srv.begin_drain('test') is True
        assert srv.begin_drain('test') is False      # idempotent
        deadline = time.time() + 15
        while srv.state != 'stopped' and time.time() < deadline:
            time.sleep(0.05)
        assert srv.state == 'stopped'
        assert time.time() - t0 >= 0.4
    finally:
        srv.stop()


def test_replica_500_chaos_point(params, monkeypatch):
    srv, _, port = _serve(params[1])
    try:
        monkeypatch.setenv(chaos.CHAOS_ENV, 'replica_500:1.0')
        status, _, text = _request(port, '/generate', {'prompt': [1]})
        assert status == 500 and 'chaos' in json.loads(text)['error']
        monkeypatch.setenv(chaos.CHAOS_ENV, '')
        status, _, _ = _request(port, '/generate',
                                {'prompt': [1, 2], 'max_new_tokens': 2,
                                 'stream': False})
        assert status == 200
    finally:
        srv.stop()


def test_healthz_staleness_503_when_loop_parked(params, monkeypatch):
    """An engine loop parked past SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS
    answers 503 'stale' though the HTTP thread is alive; fresh before."""
    monkeypatch.setenv(model_server.HEALTHZ_MAX_STALENESS_ENV, '0.05')
    monkeypatch.setenv(engine_lib.IDLE_SLEEP_ENV, '2')
    srv, _, port = _serve(params[1], num_slots=1)
    assert srv.max_staleness == 0.05
    try:
        time.sleep(0.5)                   # deep in a 2 s idle wait
        status, _, text = _request(port, '/healthz')
        assert status == 503, text
        assert text.startswith('stale staleness_seconds=')
        assert float(text.split('=', 1)[1].split()[0]) > 0.05
    finally:
        srv.stop()


def test_sigterm_drains_and_exits_in_standalone_mode(tmp_path):
    """The CLI replica installs SIGTERM -> drain in its main thread: an
    idle replica drains at once and the process exits 0."""
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    env = {**os.environ, 'PYTHONPATH': REPO_ROOT}
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.model_server',
         '--model', 'debug', '--device', 'cpu', '--host', '127.0.0.1',
         '--port', str(port), '--max-len', '64'],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                status, _, _ = _request(port, '/healthz', timeout=2)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline, 'replica did not start'
                time.sleep(0.1)
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        assert 'Draining (sigterm)' in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
