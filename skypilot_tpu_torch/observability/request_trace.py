"""The engine step profile: a per-``step()`` ring with stall detection,
whose beat is the model server's ``/healthz`` freshness signal.

This package's copy of ``EngineStepProfiler`` from
``skypilot_tpu/observability/request_trace.py``, with the same env knobs
and stall rule and without the metrics registry (the port has no
telemetry plane yet; the engine logs a stall instead of journaling it).
"""
import collections
import statistics
import threading
import time
from typing import Any, Deque, Dict, Optional, Sequence, Tuple

from skypilot_tpu_torch.utils import env

STEP_RING_ENV = 'SKYTPU_ENGINE_STEP_RING'
DEFAULT_STEP_RING = 512
# A step slower than factor × the rolling median AND past the absolute
# floor counts as a stall (the floor keeps sub-ms steps from alarming
# on scheduler jitter).
STALL_FACTOR_ENV = 'SKYTPU_ENGINE_STALL_FACTOR'
DEFAULT_STALL_FACTOR = 10.0
STALL_MIN_SECONDS_ENV = 'SKYTPU_ENGINE_STALL_MIN_SECONDS'
DEFAULT_STALL_MIN_SECONDS = 0.05
_STALL_MIN_SAMPLES = 8
_MEDIAN_WINDOW = 64


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
    return {f'p{p}': round(percentile(values, p), 6) for p in ps}


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
