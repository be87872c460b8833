"""Serving request-telemetry plane: per-request phase traces, the engine
step profile, and the SLO surface behind "why was this request slow?".

This package's copy of ``skypilot_tpu/observability/request_trace.py``
(the CLI renderers stay with the reference's CLI), with the same env
knobs, metric names and record shapes:

* :class:`RequestTelemetry` — a lock-light ring of per-request lifecycle
  records. The engine stamps enqueue/first-token/finish times on every
  ``Request``; this plane assembles them at the engine's choke points
  (submit/insert/evict/reject) into phase breakdowns (queue wait,
  prefill, TTFT, per-token decode, total) keyed by request id, with no
  per-token calls. Completed records land in a bounded deque
  (``SKYTPU_REQUEST_TRACE_CAPACITY``), exported as tenant-labeled
  ``skytpu_request_*_seconds`` histograms, the model server's
  ``/debug/requests`` and ``/slo`` bodies, and, when a request breaches
  ``SKYTPU_SLOW_REQUEST_SECONDS`` or ``SKYTPU_TTFT_SLO_SECONDS``, a
  slow-request payload the engine journals as ``engine.slow_request``
  under the request's own trace id.
* :class:`EngineStepProfiler` — a per-``step()`` ring (wall time, chunk,
  active lanes, tokens delivered, queue depth, pool use, prefill share)
  behind ``skytpu_engine_step_seconds`` and ``/debug/engine``, with
  stall detection: a step slower than ``SKYTPU_ENGINE_STALL_FACTOR`` x
  the rolling median (and past an absolute floor) reports a stall the
  engine journals as ``engine.stall``. Its beat is the model server's
  ``/healthz`` freshness signal.

Thread model: ``on_enqueue`` may fire from any server thread;
``on_admit``/``on_finish``/``record`` from the one engine loop thread;
snapshots and SLO reads from HTTP handler threads. One small lock guards
the dict/deque mutations (histograms carry their own).
"""
import collections
import statistics
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import runtime_metrics
from skypilot_tpu_torch.utils import env

# Ring capacities.
CAPACITY_ENV = 'SKYTPU_REQUEST_TRACE_CAPACITY'
DEFAULT_CAPACITY = 512
STEP_RING_ENV = 'SKYTPU_ENGINE_STEP_RING'
DEFAULT_STEP_RING = 512

# Slow-request flight recorder: a completed request whose total latency
# breaches this journals its full phase timeline (0 disables).
SLOW_REQUEST_ENV = 'SKYTPU_SLOW_REQUEST_SECONDS'
DEFAULT_SLOW_REQUEST_SECONDS = 30.0
# TTFT SLO: breach journals even when the total stayed fast (0 disables).
TTFT_SLO_ENV = 'SKYTPU_TTFT_SLO_SECONDS'
DEFAULT_TTFT_SLO_SECONDS = 0.0

# A step slower than factor × the rolling median AND past the absolute
# floor counts as a stall (the floor keeps sub-ms steps from alarming
# on scheduler jitter).
STALL_FACTOR_ENV = 'SKYTPU_ENGINE_STALL_FACTOR'
DEFAULT_STALL_FACTOR = 10.0
STALL_MIN_SECONDS_ENV = 'SKYTPU_ENGINE_STALL_MIN_SECONDS'
DEFAULT_STALL_MIN_SECONDS = 0.05
_STALL_MIN_SAMPLES = 8
_MEDIAN_WINDOW = 64

# Request-level latencies span queueing + prefill + full decodes: the
# long-tail end (2.5/5/10/30/60 s) is where a saturated replica lives.
REQUEST_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
STEP_SECONDS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (q in [0, 100]); 0.0 for an empty
    input (the reference's ``common_utils.percentile``)."""
    vs = sorted(float(v) for v in values)
    if not vs:
        return 0.0
    pos = (len(vs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def percentiles(values: Sequence[float],
                ps: Sequence[int] = (50, 95, 99)) -> Dict[str, float]:
    """``{'p50': ...}`` over :func:`percentile`; 0.0 for an empty input
    (an idle replica's SLO surface reads zeros, not NaNs)."""
    return {f'p{p}': round(percentile(values, p), 6) for p in ps}


def _reason_class(reason: Optional[str]) -> str:
    """Bounded finish-reason label: free-text reject/error strings must
    not explode metric cardinality."""
    if not reason:
        return 'other'
    if reason in ('eos', 'length'):
        return reason
    if reason.startswith('rejected'):
        return 'rejected'
    if reason.startswith('error'):
        return 'error'
    return 'other'


class _Entry:
    """One tracked request. Holds a reference to the engine's live
    ``Request`` (duck-typed: id, tenant, prompt, max_new_tokens, tokens,
    enqueue_ts, first_token_ts, finish_ts, finish_reason, trace_id)
    plus admission facts the Request itself does not carry."""

    __slots__ = ('req', 'enqueue_wall', 'slot', 'admit_ts',
                 'prefix_hit_tokens', 'blocks_reserved')

    def __init__(self, req):
        self.req = req
        self.enqueue_wall = time.time()
        self.slot = -1
        self.admit_ts: Optional[float] = None
        self.prefix_hit_tokens = 0
        self.blocks_reserved = 0


class RequestTelemetry:
    """Per-request phase tracing for one engine; see the module doc."""

    # Lock discipline: the telemetry ring is written by the engine loop
    # and read by HTTP handler threads.
    _GUARDED_BY = {
        '_in_flight': '_lock',
        '_completed': '_lock',
        '_finished': '_lock',
        '_rejected': '_lock',
        '_errors': '_lock',
        '_slow': '_lock',
    }

    def __init__(self, name: str = 'engine',
                 capacity: Optional[int] = None):
        self.name = name
        self.capacity = (capacity if capacity is not None
                         else max(1, env.env_int(
                             CAPACITY_ENV, DEFAULT_CAPACITY)))
        self._lock = threading.Lock()
        self._in_flight: 'collections.OrderedDict[str, _Entry]' = \
            collections.OrderedDict()
        self._completed: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity)
        # Monotonic totals (survive ring wraparound).
        self._finished = 0
        self._rejected = 0
        self._errors = 0
        self._slow = 0

    # -------------------------------------------------------- choke points

    def on_enqueue(self, req) -> None:
        """Request entered the admission queue (any thread)."""
        with self._lock:
            if req.id not in self._in_flight:
                self._in_flight[req.id] = _Entry(req)

    def on_admit(self, req, slot: int, admit_ts: Optional[float] = None,
                 prefix_hit_tokens: int = 0,
                 blocks_reserved: int = 0) -> None:
        """Request won a slot (engine loop thread). ``admit_ts`` is the
        perf_counter stamp taken before prefill, so the prefill phase is
        first_token - admit rather than first_token - (admit + prefill)."""
        with self._lock:
            entry = self._in_flight.get(req.id)
            if entry is None:
                entry = self._in_flight[req.id] = _Entry(req)
            entry.slot = slot
            entry.admit_ts = (admit_ts if admit_ts is not None
                              else time.perf_counter())
            entry.prefix_hit_tokens = int(prefix_hit_tokens)
            entry.blocks_reserved = int(blocks_reserved)

    def on_finish(self, req, reason: str) -> Optional[Dict[str, Any]]:
        """Request reached a terminal state (evicted, rejected, or
        failed). Freezes the phase breakdown into the completed ring,
        observes the tenant-labeled histograms, and returns the
        slow-request payload when an SLO was breached (the caller
        journals it as ``engine.slow_request`` under the request's
        trace id) — None otherwise."""
        with self._lock:
            entry = self._in_flight.pop(req.id, None)
        if entry is None:
            entry = _Entry(req)
        record = self._freeze(entry, reason)
        with self._lock:
            self._completed.append(record)
            self._finished += 1
            cls = record['reason_class']
            if cls == 'rejected':
                self._rejected += 1
            elif cls == 'error':
                self._errors += 1
        self._observe(record)
        breach = self._slo_breach(record)
        if breach is not None:
            with self._lock:
                self._slow += 1
            metrics_lib.counter(
                'skytpu_request_slow_total',
                'Requests that breached the slow-request / TTFT SLO '
                '(journaled as engine.slow_request).',
                labels=('tenant',)).inc(labels=(record['tenant'],))
        return breach

    # ----------------------------------------------------------- internals

    @staticmethod
    def _phases(entry: _Entry, req) -> Dict[str, Optional[float]]:
        """Phase split from the request's perf_counter stamps. Any stamp
        a request never reached (a reject has no first token) yields
        None for the phases that need it."""
        enq, adm = req.enqueue_ts, entry.admit_ts
        ftt, fin = req.first_token_ts, req.finish_ts
        generated = len(req.tokens)
        queue_wait = None
        if enq is not None:
            end = adm if adm is not None else fin
            if end is not None:
                queue_wait = max(0.0, end - enq)
        prefill = (max(0.0, ftt - adm)
                   if ftt is not None and adm is not None else None)
        ttft = (max(0.0, ftt - enq)
                if ftt is not None and enq is not None else None)
        decode = (max(0.0, fin - ftt)
                  if fin is not None and ftt is not None else None)
        # First token samples from the prefill logits, so decode time
        # amortizes over the generated-1 tokens the decode loop emitted.
        per_token = (decode / max(generated - 1, 1)
                     if decode is not None and generated > 1 else None)
        total = (max(0.0, fin - enq)
                 if fin is not None and enq is not None else None)
        return {'queue_wait': _round(queue_wait),
                'prefill': _round(prefill),
                'ttft': _round(ttft),
                'decode': _round(decode),
                'per_token': _round(per_token),
                'total': _round(total)}

    def _freeze(self, entry: _Entry, reason: str) -> Dict[str, Any]:
        req = entry.req
        return {
            'id': req.id,
            'tenant': req.tenant,
            'trace_id': getattr(req, 'trace_id', None),
            'state': 'done',
            'prompt_len': len(req.prompt),
            'max_new_tokens': req.max_new_tokens,
            'generated': len(req.tokens),
            'finish_reason': reason,
            'reason_class': _reason_class(reason),
            'slot': entry.slot,
            'prefix_hit_tokens': entry.prefix_hit_tokens,
            'blocks_reserved': entry.blocks_reserved,
            'enqueue_unix_ts': round(entry.enqueue_wall, 3),
            'phases': self._phases(entry, req),
        }

    def _observe(self, record: Dict[str, Any]) -> None:
        tenant = (record['tenant'],)
        ph = record['phases']
        m = metrics_lib
        if ph['queue_wait'] is not None:
            m.histogram('skytpu_request_queue_wait_seconds',
                        'Enqueue → slot admission, per request.',
                        labels=('tenant',),
                        buckets=REQUEST_SECONDS_BUCKETS).observe(
                            ph['queue_wait'], labels=tenant)
        if ph['prefill'] is not None:
            m.histogram('skytpu_request_prefill_seconds',
                        'Slot admission → first token (prefill + first '
                        'sample), per request.',
                        labels=('tenant',),
                        buckets=REQUEST_SECONDS_BUCKETS).observe(
                            ph['prefill'], labels=tenant)
        if ph['ttft'] is not None:
            m.histogram('skytpu_request_ttft_seconds',
                        'Enqueue → first token (queueing included), per '
                        'request.', labels=('tenant',),
                        buckets=REQUEST_SECONDS_BUCKETS).observe(
                            ph['ttft'], labels=tenant)
        if ph['per_token'] is not None:
            m.histogram('skytpu_request_per_token_seconds',
                        'Mean decode latency per generated token, per '
                        'request.', labels=('tenant',),
                        buckets=runtime_metrics.TOKEN_LATENCY_BUCKETS
                        ).observe(ph['per_token'], labels=tenant)
        if ph['total'] is not None:
            m.histogram('skytpu_request_total_seconds',
                        'Enqueue → terminal state, per request.',
                        labels=('tenant',),
                        buckets=REQUEST_SECONDS_BUCKETS).observe(
                            ph['total'], labels=tenant)
        m.counter('skytpu_request_finished_total',
                  'Requests reaching a terminal state, by outcome '
                  'class.', labels=('tenant', 'reason')).inc(
                      labels=(record['tenant'], record['reason_class']))

    @staticmethod
    def _slo_breach(record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Thresholds are re-read per call so a live process can be
        tightened via env without restart (and tests can monkeypatch)."""
        slow_thr = env.env_float(SLOW_REQUEST_ENV,
                                          DEFAULT_SLOW_REQUEST_SECONDS)
        ttft_thr = env.env_float(TTFT_SLO_ENV,
                                          DEFAULT_TTFT_SLO_SECONDS)
        ph = record['phases']
        breached = []
        if slow_thr > 0 and ph['total'] is not None \
                and ph['total'] >= slow_thr:
            breached.append('total')
        if ttft_thr > 0 and ph['ttft'] is not None \
                and ph['ttft'] >= ttft_thr:
            breached.append('ttft')
        if not breached:
            return None
        return {
            'tenant': record['tenant'],
            'breached': breached,
            'slow_request_seconds': slow_thr,
            'ttft_slo_seconds': ttft_thr,
            'finish_reason': record['finish_reason'],
            'prompt_len': record['prompt_len'],
            'generated': record['generated'],
            'prefix_hit_tokens': record['prefix_hit_tokens'],
            **{f'{k}_seconds': v for k, v in ph.items()
               if v is not None},
        }

    # -------------------------------------------------------------- reads

    def _live_view(self, entry: _Entry) -> Dict[str, Any]:
        req = entry.req
        now = time.perf_counter()
        view = {
            'id': req.id,
            'tenant': req.tenant,
            'trace_id': getattr(req, 'trace_id', None),
            'state': 'active' if entry.admit_ts is not None else 'queued',
            'prompt_len': len(req.prompt),
            'max_new_tokens': req.max_new_tokens,
            'generated': len(req.tokens),
            'slot': entry.slot,
            'prefix_hit_tokens': entry.prefix_hit_tokens,
            'blocks_reserved': entry.blocks_reserved,
            'enqueue_unix_ts': round(entry.enqueue_wall, 3),
            'age_seconds': (_round(max(0.0, now - req.enqueue_ts))
                            if req.enqueue_ts is not None else None),
        }
        view['phases'] = {
            'queue_wait': _round(
                max(0.0, (entry.admit_ts if entry.admit_ts is not None
                          else now) - req.enqueue_ts)
                if req.enqueue_ts is not None else None),
            'ttft': _round(
                max(0.0, req.first_token_ts - req.enqueue_ts)
                if req.first_token_ts is not None
                and req.enqueue_ts is not None else None),
        }
        return view

    def snapshot(self, last_n: Optional[int] = None) -> Dict[str, Any]:
        """In-flight + last-N completed records with full phase
        breakdowns (the ``/debug/requests`` body). Consistent: the two
        lists are cut under one lock hold."""
        with self._lock:
            in_flight = [self._live_view(e)
                         for e in self._in_flight.values()]
            completed = list(self._completed)
        completed.reverse()  # newest first
        if last_n is not None:
            completed = completed[:max(0, int(last_n))]
        return {
            'engine': self.name,
            'capacity': self.capacity,
            'in_flight': in_flight,
            'completed': completed,
        }

    def slo(self) -> Dict[str, Any]:
        """Rolling SLO surface over the completed ring: p50/p95/p99 for
        each phase plus reject/error/slow rates (the ``/slo`` body)."""
        with self._lock:
            window = list(self._completed)
            in_flight = len(self._in_flight)
            queued = sum(1 for e in self._in_flight.values()
                         if e.admit_ts is None)
            finished, rejected = self._finished, self._rejected
            errors, slow = self._errors, self._slow
        phases: Dict[str, List[float]] = {
            'queue_wait': [], 'prefill': [], 'ttft': [],
            'per_token': [], 'total': []}
        w_rejected = w_errors = 0
        for r in window:
            for k, vals in phases.items():
                v = r['phases'].get(k)
                if v is not None:
                    vals.append(v)
            if r['reason_class'] == 'rejected':
                w_rejected += 1
            elif r['reason_class'] == 'error':
                w_errors += 1
        n = len(window)
        span = (window[-1]['enqueue_unix_ts'] -
                window[0]['enqueue_unix_ts']) if n >= 2 else 0.0
        return {
            'engine': self.name,
            'window': {'capacity': self.capacity, 'completed': n,
                       'span_seconds': round(max(0.0, span), 3)},
            'in_flight': in_flight,
            'queued': queued,
            **{f'{k}_seconds': percentiles(v)
               for k, v in phases.items()},
            'rates': {
                'finished_total': finished,
                'rejected_total': rejected,
                'error_total': errors,
                'slow_total': slow,
                'reject_rate': round(w_rejected / n, 4) if n else 0.0,
                'error_rate': round(w_errors / n, 4) if n else 0.0,
            },
            'slo': {
                'slow_request_seconds': env.env_float(
                    SLOW_REQUEST_ENV, DEFAULT_SLOW_REQUEST_SECONDS),
                'ttft_slo_seconds': env.env_float(
                    TTFT_SLO_ENV, DEFAULT_TTFT_SLO_SECONDS),
            },
        }


class EngineStepProfiler:
    """Per-``step()`` ring buffer + stall detector for one engine.

    The ring, the median window and the counts are written by the engine
    loop and read by HTTP threads under ``_lock``; ``_last_beat`` is a
    float stamp read without it."""

    def __init__(self, name: str = 'engine',
                 capacity: Optional[int] = None,
                 stall_factor: Optional[float] = None,
                 stall_min_seconds: Optional[float] = None):
        self.name = name
        self.capacity = (capacity if capacity is not None
                         else max(1, env.env_int(STEP_RING_ENV,
                                                 DEFAULT_STEP_RING)))
        self.stall_factor = (stall_factor if stall_factor is not None
                             else env.env_float(STALL_FACTOR_ENV,
                                                DEFAULT_STALL_FACTOR))
        self.stall_min_seconds = (
            stall_min_seconds if stall_min_seconds is not None
            else env.env_float(STALL_MIN_SECONDS_ENV,
                               DEFAULT_STALL_MIN_SECONDS))
        self._lock = threading.Lock()
        self._ring: Deque[Tuple] = collections.deque(maxlen=self.capacity)
        self._recent: Deque[float] = collections.deque(
            maxlen=_MEDIAN_WINDOW)
        self._steps = 0
        self._stalls = 0
        self._last_beat = 0.0

    def beat(self) -> None:
        """Liveness stamp: every engine loop iteration, idle included."""
        self._last_beat = time.time()

    def record(self, step_seconds: float, chunk: int, active: int,
               delivered: int, queue_depth: int, blocks_used: int = 0,
               blocks_total: int = 0,
               prefill_tokens: int = 0) -> Optional[Dict[str, Any]]:
        """Record one engine step; returns a stall payload when it took
        more than ``stall_factor`` × the rolling median (and at least
        ``stall_min_seconds``), else None. ``prefill_tokens`` is the
        step's chunked-prefill share, so a chunk-induced stall reads
        apart from a wedged decode."""
        now = time.time()
        self._last_beat = now
        step_seconds = float(step_seconds)
        metrics_lib.histogram(
            'skytpu_engine_step_seconds',
            'Wall time of one fused engine step (whole chunk).',
            buckets=STEP_SECONDS_BUCKETS).observe(step_seconds)
        stall = None
        with self._lock:
            median = (statistics.median(self._recent)
                      if len(self._recent) >= _STALL_MIN_SAMPLES
                      else None)
            if (median is not None and median > 0 and
                    step_seconds >= self.stall_min_seconds and
                    step_seconds > self.stall_factor * median):
                self._stalls += 1
                stall = {
                    'step_seconds': round(step_seconds, 6),
                    'rolling_median_seconds': round(median, 6),
                    'stall_factor': self.stall_factor,
                    'active_slots': active,
                    'queue_depth': queue_depth,
                    'prefill_tokens': int(prefill_tokens),
                    'decode_tokens': int(delivered),
                }
            # The stalled step joins the window after the check, so it
            # cannot vouch for itself.
            self._recent.append(step_seconds)
            self._ring.append((now, step_seconds, int(chunk), int(active),
                               int(delivered), int(queue_depth),
                               int(blocks_used), int(blocks_total),
                               int(prefill_tokens)))
            self._steps += 1
        if stall is not None:
            metrics_lib.counter(
                'skytpu_engine_stalls_total',
                'Engine steps that exceeded the stall threshold '
                '(journaled as engine.stall).').inc()
        return stall

    def steps_recorded(self) -> int:
        return self._steps

    def stall_count(self) -> int:
        return self._stalls

    def heartbeat_ts(self) -> float:
        """Unix time of the last beat or record (0.0 = never)."""
        return self._last_beat

    def snapshot(self, last_n: int = 32) -> Dict[str, Any]:
        """Aggregates over the ring plus the most recent steps, newest
        first."""
        with self._lock:
            ring = list(self._ring)
            steps, stalls = self._steps, self._stalls
            median = (statistics.median(self._recent)
                      if self._recent else 0.0)
        durs = [r[1] for r in ring]
        keys = ('unix_ts', 'step_seconds', 'chunk', 'active_slots',
                'delivered_tokens', 'queue_depth', 'blocks_used',
                'blocks_total', 'prefill_tokens')
        tail = ring[-last_n:] if last_n > 0 else []
        recent = [dict(zip(keys, r)) for r in reversed(tail)]
        return {
            'engine': self.name,
            'capacity': self.capacity,
            'steps_recorded': steps,
            'stalls': stalls,
            'stall_factor': self.stall_factor,
            'stall_min_seconds': self.stall_min_seconds,
            'rolling_median_seconds': round(median, 6),
            'last_step_age_seconds': (
                round(max(0.0, time.time() - self._last_beat), 3)
                if self._last_beat else None),
            'step_seconds': percentiles(durs),
            'mean_step_seconds': (round(sum(durs) / len(durs), 6)
                                  if durs else 0.0),
            'recent': recent,
        }
