"""Serving cells: the port's replica (``serve/model_server.ModelServer``
over a paged ``models/engine.DecodeEngine`` with replayed rounds) under
open-loop traffic over HTTP on loopback, from a load generator in a
process of its own (``portbench/loadgen.py``).

A run: weights from the seed on the card; the replica with the
configuration's ``deployment`` settings; one request of each prefill
shape the mix can reach, then ``warm_seconds`` of the mix itself, all
set-up; then the window, whose requests are counted; then, with the
replica stopped and its memory freed, the plain reference over a sample
of the window's requests (:func:`check_served`).
"""
import dataclasses
import gc
import http.client
import json
import math
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from portbench import harness, peaks, reference, weights
from portbench.generators import open_loop

# The program's in-memory rings, sized to hold a whole run.
PROGRAM_ENV = {'SKYTPU_REQUEST_TRACE_CAPACITY': '16384',
               'SKYTPU_ENGINE_STEP_RING': '200000'}
GRACE_SECONDS = 60.0
# A traced run profiles this many seconds, ending TRACE_MARGIN seconds
# before the window closes.
TRACE_SECONDS, TRACE_MARGIN = 2.0, 0.5


@dataclasses.dataclass
class ServeContext:
    """What the metric readers of a serving cell read."""
    dims: weights.Dims
    traffic: Dict[str, Any]
    records: List[Dict[str, Any]]
    window: tuple
    window_unix: tuple
    setup_s: float
    requests: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    steps: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    trace: Optional[harness.Trace] = None
    trace_window: Optional[tuple] = None
    # Traced runs: the monotonic seconds from asking the engine's loop
    # to start the profiler to the loop's next step after it stopped.
    # The engine ran nothing else meanwhile (the stop alone holds it for
    # seconds), so the engine's per-layer metrics leave them out.
    held: Optional[tuple] = None
    peak_bytes: int = 0

    @property
    def counted(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r['counted']]

    def clear(self, start: float, end: float) -> bool:
        """Whether the monotonic interval [start, end] misses ``held``."""
        return (self.held is None or end < self.held[0] or
                start > self.held[1])

    def unheld(self) -> List[Dict[str, Any]]:
        """The counted requests whose life, from due to last token,
        missed ``held``: every counted request of an untraced run."""
        return [r for r in self.counted if self.clear(
            r['due'], r['times'][-1] if r['times'] else math.inf)]

    def unheld_requests(self) -> List[Dict[str, Any]]:
        """The program's records of :meth:`unheld`'s requests."""
        ids = {r['id'] for r in self.unheld()}
        return [r for r in self.requests if r.get('trace_id') in ids]

    def unheld_steps(self) -> List[Dict[str, Any]]:
        """The window's engine steps that missed ``held`` (a step's
        ``unix_ts`` is its end)."""
        offset = self.window_unix[0] - self.window[0]
        return [s for s in self.steps if self.clear(
            s['unix_ts'] - s['step_seconds'] - offset,
            s['unix_ts'] - offset)]

    def unheld_seconds(self) -> float:
        """The window's seconds outside ``held``."""
        t0, t1 = self.window
        if self.held is None:
            return t1 - t0
        return (t1 - t0) - max(0.0, min(t1, self.held[1]) -
                               max(t0, self.held[0]))

    def active_params(self) -> int:
        d = self.dims
        return (d.n_layers * peaks.dense_block_params(
            d.dim, d.n_heads, d.n_kv_heads, d.head_dim, d.ffn_dim) +
            d.dim * d.vocab)


class EngineTracer:
    """Starts and stops the profiler on the engine's own thread, between
    two of its steps. Stopping the device tracer from another thread
    while the engine launches a graph hangs in the profiler, so the
    harness asks and the engine's loop carries the request out before
    its next step (``step`` is wrapped on this engine object alone).
    The engine's host operations are then the ones traced."""

    def __init__(self, torch, eng):
        self._torch = torch
        self._step = eng.step
        self._asks: queue.Queue = queue.Queue()
        self.prof = None
        self._mark = None
        self._m0 = 0.0
        self.window: Optional[tuple] = None
        eng.step = self._wrapped

    def _wrapped(self) -> int:
        try:
            action, done, failure = self._asks.get_nowait()
        except queue.Empty:
            return self._step()
        try:
            action()
        except Exception as e:  # pylint: disable=broad-except
            failure.append(e)  # raised again in the asking thread
        done.set()
        return self._step()

    def _ask(self, action) -> None:
        done, failure = threading.Event(), []
        self._asks.put((action, done, failure))
        if not done.wait(60.0):
            raise RuntimeError('the engine loop took no profiler request '
                               'within 60 s')
        if failure:
            raise failure[0]

    def start(self) -> float:
        """Start profiling; returns the monotonic time it began."""
        def begin():
            self.prof = harness.profiler(self._torch)
            self.prof.start()
            self._mark = self._torch.profiler.record_function(
                harness.WINDOW_MARK)
            self._mark.__enter__()
            self._m0 = time.monotonic()
        self._ask(begin)
        return self._m0

    def stop(self) -> None:
        """Close the traced window (``window``: its monotonic ends) once
        the card has run what was launched in it, and stop profiling."""
        def end():
            self._torch.cuda.synchronize()
            m1 = time.monotonic()
            self._mark.__exit__(None, None, None)
            self.prof.stop()
            self.window = (self._m0, m1)
        self._ask(end)


def llama_config(d: weights.Dims, dep: Dict[str, Any]):
    import torch
    from skypilot_tpu_torch.models import llama
    return llama.LlamaConfig(
        vocab_size=d.vocab, dim=d.dim, n_layers=d.n_layers,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, ffn_dim=d.ffn_dim,
        max_seq_len=dep['max_len'], rope_theta=d.rope_theta,
        norm_eps=d.norm_eps, dtype=torch.bfloat16)


def start_replica(d: weights.Dims, dep: Dict[str, Any], params, seed: int,
                  name: str):
    """The engine and its HTTP server (started, on a free loopback
    port), assembled as ``model_server.build_engine`` assembles a paged
    replica; that function takes only a model of ``llama.CONFIGS``."""
    import torch
    os.environ.update(PROGRAM_ENV)
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models import engine as engine_lib
    from skypilot_tpu_torch.serve import model_server
    cfg = llama_config(d, dep)
    dcfg = decode.DecodeConfig(
        max_len=dep['max_len'], temperature=0.0, eos_id=None,
        decode_attention=dep['decode_attention'],
        kv_cache_dtype=dep['kv_cache_dtype'],
        kernel_block_k=dep['block_k'])
    device = params['tok_embedding'].device
    sampler = torch.Generator(device=device)
    sampler.manual_seed(int(seed) % 2**63)
    eng = engine_lib.DecodeEngine(
        params, cfg, dcfg, dep['num_slots'], step_chunk=dep['step_chunk'],
        generator=sampler, name=name, paged=dep['paged'],
        prefill_chunk=dep['prefill_chunk'], prefix_peers=[],
        rounds=dep['rounds'])
    server = model_server.ModelServer(eng, 0, host='127.0.0.1')
    return eng, server, server.start()


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 600.0):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise RuntimeError(f'{method} {path}: http {resp.status} '
                               f'{payload[:200]!r}')
        return json.loads(payload)
    finally:
        conn.close()


def warm_shapes(port: int, traffic: Dict[str, Any], vocab: int) -> None:
    """One request of each prefill shape the mix reaches, one at a
    time, each long enough to run decode rounds."""
    rng = np.random.default_rng(0)
    for n in open_loop.warm_lengths(traffic):
        http_json(port, 'POST', '/generate',
                  {'prompt': rng.integers(0, vocab, n).tolist(),
                   'max_new_tokens': 9, 'stream': False})


def start_load(port: int, traffic, rate: float, seconds: float, seed: int,
               vocab: int, window_start: float) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, str(harness.PB / 'loadgen.py')],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    proc.stdin.write(json.dumps({
        'port': port, 'traffic': traffic, 'rate': rate,
        'seconds': seconds, 'seed': seed, 'vocab': vocab,
        'window_start': window_start, 'grace': GRACE_SECONDS}).encode())
    proc.stdin.close()
    return proc


def finish_load(proc: subprocess.Popen) -> List[Dict[str, Any]]:
    out = proc.stdout.read()
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f'load generator exited {proc.returncode}')
    return json.loads(out)['requests']


def sleep_until(t: float) -> None:
    delay = t - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def failed(r: Dict[str, Any]) -> bool:
    return r['error'] is not None or len(r['tokens']) != r['max_new_tokens']


def check_sample(records, seed: int, want_tokens: int) -> List[Dict]:
    """The window's finished requests the reference replays: the
    longest, then others in an order drawn from the seed, until they
    hold ``want_tokens`` served tokens."""
    done = [r for r in records if r['counted'] and not failed(r)]
    if not done:
        return []
    done.sort(key=lambda r: r['id'])
    longest = max(done, key=lambda r: r['prompt_len'] + len(r['tokens']))
    order = np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, 99])).permutation(
            len(done))
    picked, served = [longest], len(longest['tokens'])
    for i in order:
        if served >= want_tokens:
            break
        if done[i] is not longest:
            picked.append(done[i])
            served += len(done[i]['tokens'])
    return picked


def check_served(params, d: weights.Dims, sample: List[Dict],
                 prompts: Dict[str, List[int]], control: bool = False
                 ) -> Dict[str, float]:
    """The reference over each sampled prompt and its served tokens:
    the widest gap by which a served token's logit lies below the
    reference's best (``served_logit_gap``). With ``control``, also the
    control's reading: at the same positions, the gap of the token that
    the reference computed in fp8 puts first (``control_logit_gap``)."""
    import torch
    dev = params['tok_embedding'].device
    seqs, rows, served = [], [], []
    for r in sample:
        prompt, toks = prompts[r['id']], r['tokens']
        seqs.append(torch.tensor(prompt + toks[:-1], device=dev))
        p = len(prompt)
        rows.append(torch.arange(p - 1, p - 1 + len(toks), device=dev))
        served.append(torch.tensor(toks, device=dev))
    mms = {'ref': reference.fp32_mm}
    if control:
        mms['control'] = reference.fp8_mm
    with torch.no_grad(), reference.exact_fp32():
        logits = reference.served_logits(params, d, seqs, rows, mms)
        out = {'served_logit_gap': max(
            reference.widest_gap(lg, tok)
            for lg, tok in zip(logits['ref'], served))}
        if control:
            out['control_logit_gap'] = max(
                reference.widest_gap(lg, ctl.argmax(-1))
                for lg, ctl in zip(logits['ref'], logits['control']))
    return out


def window_run(port: int, cell: harness.Cell, d: weights.Dims, seed: int,
               seconds: float, tracer: Optional[EngineTracer],
               t_start: float):
    """Warm traffic, then the window (traced through ``tracer`` near its
    end, if given); returns the context (records not yet filled) and the
    load generator's process."""
    rate = float(cell.spec['rate_per_s'])
    warm = float(cell.traffic.get('warm_seconds', 0.0))
    # The load generator needs ~1 s to start and build its schedule.
    window_start = time.monotonic() + warm + 1.5
    proc = start_load(port, cell.traffic, rate, seconds, seed, d.vocab,
                      window_start)
    try:
        return _window(cell, d, proc, window_start, seconds, tracer,
                       t_start), proc
    except BaseException:
        proc.kill()
        proc.wait()
        raise


def _window(cell: harness.Cell, d: weights.Dims, proc, window_start: float,
            seconds: float, tracer: Optional[EngineTracer],
            t_start: float) -> ServeContext:
    import torch
    sleep_until(window_start)
    setup_s = time.monotonic() - t_start
    u0 = time.time()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    end = window_start + seconds
    held = None
    if tracer is not None:
        sleep_until(end - TRACE_SECONDS - TRACE_MARGIN)
        asked = time.monotonic()
        m0 = tracer.start()
        sleep_until(m0 + TRACE_SECONDS)
        tracer.stop()
        held = (asked, time.monotonic())
        print(f'traced {tracer.window[1] - tracer.window[0]:.3f} s; the '
              f'profiler held the engine {held[1] - held[0]:.2f} s',
              file=sys.stderr, flush=True)
    sleep_until(end)
    u1 = time.time()
    peak = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else 0)
    return ServeContext(
        dims=d, traffic=cell.traffic, records=[],
        window=(window_start, end), window_unix=(u0, u1), setup_s=setup_s,
        trace_window=tracer.window if tracer else None, held=held,
        peak_bytes=peak)


def captures(eng) -> int:
    return sum(eng.graph_stats().get('captures', {}).values())


def read_engine(port: int, ctx: ServeContext) -> None:
    """The program's own records of the window: its requests' phases
    and its steps."""
    ids = {r['id'] for r in ctx.counted}
    reqs = http_json(port, 'GET', '/debug/requests?n=16384')['completed']
    ctx.requests = [r for r in reqs if r.get('trace_id') in ids]
    u0, u1 = ctx.window_unix
    steps = http_json(port, 'GET', '/debug/engine?n=200000')[
        'step_profile']['recent']
    ctx.steps = [s for s in steps if u0 <= s['unix_ts'] <= u1]


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> harness.Outcome:
    import torch
    d = weights.dims_of(cell.config)
    dep = cell.config['deployment']
    if trace:
        # The device tracer is set up before the replica captures its
        # graphs, so that their replays are traced kernel by kernel.
        harness.warm_profiler(torch)
    harness.stage('imports', t_start)
    params = weights.make_params(d, seed, device)
    harness.stage('weights', t_start)
    eng, server, port = start_replica(d, dep, params, seed, cell.name)
    harness.stage('replica', t_start)
    tracer = EngineTracer(torch, eng) if trace else None
    try:
        warm_shapes(port, cell.traffic, d.vocab)
        harness.stage('prefill shapes', t_start)
        warmed = captures(eng)
        ctx, proc = window_run(port, cell, d, seed, seconds, tracer,
                               t_start)
        ctx.records = finish_load(proc)
        read_engine(port, ctx)
        # A capture after the shape warm-up compiled inside the run.
        print(f'graph captures: {warmed} in set-up, '
              f'{captures(eng) - warmed} after it', file=sys.stderr)
    finally:
        server.stop()
        eng.close()
    del eng, server
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if tracer is not None:
        ctx.trace = harness.export_and_reduce(
            tracer.prof, harness.CACHE_DIR / 'serve_trace.json')
        del tracer
    counted = ctx.counted
    n_failed = sum(failed(r) for r in counted)
    prompts = {r['id']: r['prompt'] for r in open_loop.schedule(
        cell.traffic, float(cell.spec['rate_per_s']), seconds, seed,
        d.vocab)}
    sample = check_sample(ctx.records, seed, cell.spec['check_tokens'])
    checks, complete = {}, bool(sample)
    if sample:
        got = check_served(params, d, sample, prompts)
        limit = cell.spec['limits']['served_logit_gap']
        checks['served_logit_gap'] = (got['served_logit_gap'], limit)
        print(f'checked {len(sample)} requests, '
              f'{sum(len(r["tokens"]) for r in sample)} served tokens',
              file=sys.stderr)
    return harness.Outcome(checks=checks, attempted=len(counted),
                           failed=n_failed,
                           device=harness.device_info(torch, ctx),
                           context=ctx, complete=complete)


def ttfts(ctx: ServeContext) -> List[float]:
    """Seconds from each counted request's due time to its first
    streamed token (``inf`` for a request that failed)."""
    return [math.inf if failed(r) else r['times'][0] - r['due']
            for r in ctx.counted]


def tpots(ctx: ServeContext) -> List[float]:
    """Each counted request's (last token − first token) / (tokens − 1)
    at the client (``inf`` for a request that failed)."""
    out = []
    for r in ctx.counted:
        n = len(r['times'])
        if failed(r) or n < 2:
            out.append(math.inf)
        else:
            out.append((r['times'][-1] - r['times'][0]) / (n - 1))
    return out
