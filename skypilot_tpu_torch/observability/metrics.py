"""Thread-safe, dependency-free metrics registry with Prometheus exposition.

This package's copy of ``skypilot_tpu/observability/metrics.py`` (the
replica's telemetry plane reads and writes the same series, under the
same names, in the same text format): Counter / Gauge / Histogram with
labels, one registry per process by default, and text-format exposition
(``generate_latest``, content type ``text/plain; version=0.0.4``).

Conventions, as in the reference:

* Every metric name matches ``^skytpu_[a-z0-9_]+$`` (enforced at
  registration).
* Metric construction is get-or-create: calling :func:`counter` twice
  with the same name returns the SAME metric object, so instrumentation
  sites resolve their metric at call time and tests can swap the
  process registry (:func:`set_registry`).
* Label sets are fixed at first registration; re-registering with a
  different type, label names or buckets raises.

The registry is this package's own object: a process that imports both
packages holds two registries that never share a series.
"""
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

METRIC_NAME_PATTERN = r'^skytpu_[a-z0-9_]+$'
_NAME_RE = re.compile(METRIC_NAME_PATTERN)
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*$')

# Label-cardinality guard: these label NAMES are rejected at
# registration because their values are unbounded by construction —
# per-request ids would mint one child series per request and grow the
# registry (and every scrape) without bound. Request-scoped telemetry
# belongs in the journal (keyed by trace id) or the request-trace ring,
# not in metric labels.
UNBOUNDED_LABEL_NAMES = frozenset({
    'request_id', 'request', 'trace_id', 'span_id',
})

# The VALUE half of the same guard: expression fragments that mark a
# label value as derived from a per-request identifier.
UNBOUNDED_LABEL_VALUE_MARKERS = ('trace_id', 'request_id', 'req.id',
                                 'request.id', 'span_id')

# Default histogram buckets: wide enough to cover sub-ms decode token
# latencies and multi-minute spans in one scheme.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                   300.0, 600.0)

CONTENT_TYPE_LATEST = 'text/plain; version=0.0.4; charset=utf-8'


def _noop_write() -> None:
    pass


def format_float(v: float) -> str:
    """Prometheus sample-value formatting ('+Inf', integers without
    trailing '.0')."""
    v = float(v)
    if math.isinf(v):
        return '+Inf' if v > 0 else '-Inf'
    if math.isnan(v):
        return 'NaN'
    s = repr(v)
    if s.endswith('.0'):
        s = s[:-2]
    return s


def normalize_buckets(buckets: Sequence[float]) -> Tuple[float, ...]:
    """Sorted finite upper bounds (+Inf is implicit and dropped)."""
    bs = sorted(float(b) for b in buckets)
    if bs and math.isinf(bs[-1]):
        bs = bs[:-1]
    if not bs:
        raise ValueError('Histogram needs at least one finite bucket')
    return tuple(bs)


def escape_label_value(v: str) -> str:
    """Backslash, double-quote and newline escaping per the text format."""
    return str(v).replace('\\', r'\\').replace('\n', r'\n').replace(
        '"', r'\"')


def _escape_help(v: str) -> str:
    return str(v).replace('\\', r'\\').replace('\n', r'\n')


class Metric:
    """Base: a named family of label-keyed children."""

    kind = ''

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(
                f'Metric name {name!r} must match {METRIC_NAME_PATTERN}')
        for label in labels:
            if not _LABEL_RE.match(label):
                raise ValueError(f'Invalid label name {label!r}')
            if label in UNBOUNDED_LABEL_NAMES:
                raise ValueError(
                    f'Label {label!r} on {name!r} is unbounded by '
                    'construction (one series per request); key '
                    'request-scoped telemetry by trace id in the '
                    'journal / request-trace ring instead.')
        self.name = name
        self.help_text = help_text
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        # Wired to the owning registry's write stamp at registration;
        # metrics constructed outside a registry keep the no-op.
        self._on_write: 'callable' = _noop_write

    def _note_write(self) -> None:
        self._on_write()

    def _key(self, labels: Sequence[str]) -> Tuple[str, ...]:
        key = tuple(str(v) for v in labels)
        if len(key) != len(self.label_names):
            raise ValueError(
                f'{self.name}: got {len(key)} label values for '
                f'{len(self.label_names)} labels {self.label_names}')
        return key

    def remove(self, labels: Sequence[str] = ()) -> None:
        """Drop one labeled child series. For gauges whose label values
        churn over a process lifetime (fleet replica URLs): a departed
        replica's series must disappear from the exposition instead of
        exporting its last value — and leaking one series per
        ever-seen value — forever. No-op when the child never existed."""
        key = self._key(labels)
        with self._lock:
            self._children.pop(key, None)
        self._note_write()

    def _render_series(self, suffix: str, key: Tuple[str, ...], value,
                       extra_labels: Sequence[Tuple[str, str]] = ()
                       ) -> str:
        pairs = [f'{n}="{escape_label_value(v)}"'
                 for n, v in zip(self.label_names, key)]
        pairs += [f'{n}="{escape_label_value(v)}"'
                  for n, v in extra_labels]
        label_str = '{' + ','.join(pairs) + '}' if pairs else ''
        return f'{self.name}{suffix}{label_str} {format_float(value)}'

    def expose(self) -> List[str]:
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [f'# HELP {self.name} {_escape_help(self.help_text)}',
                f'# TYPE {self.name} {self.kind}']


class Counter(Metric):
    """Monotonically increasing count."""

    kind = 'counter'

    def inc(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        if amount < 0:
            raise ValueError('Counters can only increase')
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount
        self._note_write()

    def value(self, labels: Sequence[str] = ()) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        return self._header() + [self._render_series('', k, v)
                                 for k, v in items]


class Gauge(Metric):
    """A value that can go up and down."""

    kind = 'gauge'

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)
        self._note_write()

    def inc(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount
        self._note_write()

    def dec(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        self.inc(-amount, labels)

    def value(self, labels: Sequence[str] = ()) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        return self._header() + [self._render_series('', k, v)
                                 for k, v in items]


class _HistogramChild:
    __slots__ = ('bucket_counts', 'total', 'count')

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(Metric):
    """Observations bucketed by upper bound, with ``_sum`` and ``_count``.

    Exposition follows the Prometheus scheme exactly: ``_bucket`` series
    are CUMULATIVE and always end with ``le="+Inf"`` equal to ``_count``.
    """

    kind = 'histogram'

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = normalize_buckets(buckets)

    def observe(self, value: float, labels: Sequence[str] = ()) -> None:
        value = float(value)
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _HistogramChild(len(self.buckets) + 1)
                self._children[key] = child
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child.bucket_counts[i] += 1
                    break
            else:
                child.bucket_counts[-1] += 1  # > largest bound → +Inf only
            child.total += value
            child.count += 1
        self._note_write()

    def count(self, labels: Sequence[str] = ()) -> int:
        with self._lock:
            child = self._children.get(self._key(labels))
            return child.count if child else 0

    def sum(self, labels: Sequence[str] = ()) -> float:
        with self._lock:
            child = self._children.get(self._key(labels))
            return child.total if child else 0.0

    def expose(self) -> List[str]:
        with self._lock:
            items = [(k, list(c.bucket_counts), c.total, c.count)
                     for k, c in sorted(self._children.items())]
        lines = self._header()
        for key, per_bucket, total, count in items:
            cumulative = 0
            for bound, n in zip(self.buckets, per_bucket):
                cumulative += n
                lines.append(self._render_series(
                    '_bucket', key, cumulative,
                    extra_labels=[('le', format_float(bound))]))
            lines.append(self._render_series(
                '_bucket', key, count, extra_labels=[('le', '+Inf')]))
            lines.append(self._render_series('_sum', key, total))
            lines.append(self._render_series('_count', key, count))
        return lines


class MetricsRegistry:
    """Name → Metric map with get-or-create registration.

    ``last_write_ts`` is stamped on every metric mutation: how stale
    this process's telemetry is (a wedged process keeps serving but
    stops writing).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self.last_write_ts = 0.0

    def _stamp_write(self) -> None:
        # Plain float store: atomic under the GIL, and a heartbeat may
        # be a hair late without consequence — no lock on the hot path.
        self.last_write_ts = time.time()

    def _get_or_create(self, cls, name: str, help_text: str,
                       labels: Sequence[str], **kwargs) -> Metric:
        labels = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f'{name!r} already registered as '
                        f'{type(existing).__name__}, not {cls.__name__}')
                if existing.label_names != labels:
                    raise ValueError(
                        f'{name!r} already registered with labels '
                        f'{existing.label_names}, not {labels}')
                return existing
            metric = cls(name, help_text, labels, **kwargs)
            metric._on_write = self._stamp_write  # pylint: disable=protected-access
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = '',
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = '',
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = '',
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        metric = self._get_or_create(Histogram, name, help_text, labels,
                                     buckets=buckets)
        # Buckets are part of the registration contract too: a second
        # call site with a different scheme would silently get the first
        # one's le= series (read-side lookups should use get()).
        if metric.buckets != normalize_buckets(buckets):
            raise ValueError(
                f'{name!r} already registered with buckets '
                f'{metric.buckets}, not {tuple(buckets)}')
        return metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def generate_latest(self) -> bytes:
        """Prometheus text-format exposition of every registered metric."""
        lines: List[str] = []
        for metric in self.metrics():
            lines.extend(metric.expose())
        return ('\n'.join(lines) + '\n').encode('utf-8')


# Process-global registry. Instrumentation sites resolve metrics through
# the module helpers at CALL time, so tests can swap in a fresh registry.
_registry = MetricsRegistry()
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous."""
    global _registry
    with _registry_lock:
        prev = _registry
        _registry = registry
        return prev


def counter(name: str, help_text: str = '',
            labels: Sequence[str] = ()) -> Counter:
    return _registry.counter(name, help_text, labels)


def gauge(name: str, help_text: str = '',
          labels: Sequence[str] = ()) -> Gauge:
    return _registry.gauge(name, help_text, labels)


def histogram(name: str, help_text: str = '', labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return _registry.histogram(name, help_text, labels, buckets=buckets)


def generate_latest(registry: Optional[MetricsRegistry] = None) -> bytes:
    return (registry or _registry).generate_latest()
