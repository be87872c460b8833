"""The replica's flight recorder: an append-only structured event journal.

This package's copy of ``skypilot_tpu/observability/journal.py``, with
the same table schema and the same :class:`EventKind` values, so the
reference's readers (``skytpu events``, ``skytpu trace``) read a port
replica's journal file as they read their own. The CLI renderers stay
with the reference's CLI, which reads the same file.

Design rules, as in the reference:

* **Bounded vocabulary.** Event kinds come from :class:`EventKind`; an
  unregistered kind raises immediately.
* **Best-effort writes.** A full disk or locked database must never fail
  the serving plane: sqlite/OS errors are swallowed (the kind check is a
  programming error and is not).
* **Bounded size.** The table self-prunes to
  ``SKYTPU_JOURNAL_MAX_EVENTS`` (default 20000) rows by rowid: O(1) per
  insert, no table scans.
* **Local by design.** Each host journals to its own
  ``~/.skytpu/journal.db`` (``SKYTPU_JOURNAL_PATH`` overrides it);
  cross-host linkage is by trace id, not by a shared database.
* **Hot-path writers buffer.** :class:`JournalBuffer` batches rows into
  one transaction per engine tick and hands the write to a short-lived
  background thread, so a wedged journal disk never blocks the decode
  loop.
"""
import enum
import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import trace as trace_lib
from skypilot_tpu_torch.utils import chaos
from skypilot_tpu_torch.utils import db_utils

DISABLE_ENV = 'SKYTPU_JOURNAL_DISABLED'
# Comma-separated kind values: when set, ONLY those kinds are written
# (everything else is dropped silently). The benchmark harness uses it
# to keep slow-request breaches joinable (`skytpu trace`) while the
# measured engine passes stay free of per-tick admit/evict fsyncs.
ONLY_KINDS_ENV = 'SKYTPU_JOURNAL_ONLY_KINDS'
MAX_EVENTS_ENV = 'SKYTPU_JOURNAL_MAX_EVENTS'
DEFAULT_MAX_EVENTS = 20000
# job.phase rows are exempt from the generic prune (goodput recomputes
# from them) and capped separately, much higher — see event().
PHASE_EVENTS_CAP = 50000
# Journal file override: lets several in-process instances (the federated
# flight-recorder e2e: LB + prefill replica + decode replica) keep
# genuinely separate journals; in prod each host resolves its own
# ~/.skytpu/journal.db and the env is a deploy-time escape hatch (tmpfs,
# per-replica volumes).
DB_PATH_ENV = 'SKYTPU_JOURNAL_PATH'
# JournalBuffer bound: appends beyond this depth are dropped (and
# counted) instead of growing without bound while the writer is stalled.
QUEUE_DEPTH_ENV = 'SKYTPU_JOURNAL_QUEUE_DEPTH'
DEFAULT_QUEUE_DEPTH = 4096
# A flush slower than this journals ONE journal.stall row on recovery.
STALL_SECONDS_ENV = 'SKYTPU_JOURNAL_STALL_SECONDS'
DEFAULT_STALL_SECONDS = 1.0
# Hard cap on rows a /journal query endpoint will serve per call.
QUERY_LIMIT_ENV = 'SKYTPU_JOURNAL_QUERY_LIMIT'
DEFAULT_QUERY_LIMIT = 1000


class EventKind(enum.Enum):
    """The journal's full vocabulary: the reference's values, kind for
    kind, so either package's reader reads the other's rows. Add a kind
    to both at once."""
    # Span structure (emitted by trace.span()).
    SPAN_START = 'span.start'
    SPAN_END = 'span.end'
    # execution.py lifecycle.
    LAUNCH_START = 'launch.start'
    LAUNCH_DONE = 'launch.done'
    LAUNCH_ERROR = 'launch.error'
    # Provision failover engine (gang_backend.RetryingProvisioner).
    PROVISION_ATTEMPT = 'provision.attempt'
    PROVISION_FAILOVER = 'provision.failover'
    PROVISION_DONE = 'provision.done'
    # Provision orchestrator phases (provision/provisioner.py).
    PROVISION_WAIT_SSH = 'provision.wait_ssh'
    PROVISION_RUNTIME_SETUP = 'provision.runtime_setup'
    # Cluster backend (gang_backend.TpuGangBackend).
    BACKEND_JOB_SUBMIT = 'backend.job_submit'
    CLUSTER_TEARDOWN = 'cluster.teardown'
    # On-cluster runtime (skylet/).
    SKYLET_JOB_START = 'skylet.job_start'
    SKYLET_JOB_END = 'skylet.job_end'
    SKYLET_AUTOSTOP = 'skylet.autostop'
    SKYLET_EVENT_ERROR = 'skylet.event_error'
    # Fleet telemetry (observability/fleet.py).
    NODE_STALE = 'node.stale'
    NODE_STRAGGLER = 'node.straggler'
    # Managed jobs (jobs/).
    JOB_CREATED = 'job.created'
    JOB_PHASE = 'job.phase'
    JOB_RECOVER_START = 'job.recover_start'
    JOB_RECOVER_DONE = 'job.recover_done'
    RECOVERY_SWEEP = 'recovery.sweep'
    # Serve replica lifecycle (serve/replica_managers.py).
    REPLICA_TRANSITION = 'replica.transition'
    # Continuous-batching decode engine (models/engine.py): slot
    # admission/eviction — the scheduling decisions behind a serving
    # replica's latency, reconstructable per request id.
    ENGINE_ADMIT = 'engine.admit'
    ENGINE_EVICT = 'engine.evict'
    # Admission-control decisions: over-budget requests clamped or
    # rejected instead of crashing the serve loop.
    ENGINE_REJECT = 'engine.reject'
    # Request-telemetry plane (observability/request_trace.py): a
    # completed request that breached SKYTPU_SLOW_REQUEST_SECONDS or
    # the TTFT SLO journals its full phase timeline under the request's
    # own trace id (X-Request-Id), and an engine step that blew past
    # the stall threshold journals the step profile evidence.
    ENGINE_SLOW_REQUEST = 'engine.slow_request'
    ENGINE_STALL = 'engine.stall'
    # Speculative decoding + chunked prefill (models/engine.py):
    # journaled the first time each (bucket, chunk, spec_k) dispatch
    # shape traces, so recompile churn from new shapes is visible
    # instead of silently eating p99.
    ENGINE_COMPILE = 'engine.compile'
    # Serving-plane fault tolerance: the engine supervisor's crash →
    # fail-fast → rebuild → restart lifecycle (engine.crash carries the
    # traceback; restarts are bounded by SKYTPU_ENGINE_MAX_RESTARTS),
    # the model server's graceful-drain phases, and load-balancer
    # circuit-breaker ejections/reinstatements.
    ENGINE_CRASH = 'engine.crash'
    ENGINE_RESTART = 'engine.restart'
    SERVER_DRAIN = 'server.drain'
    LB_EJECT = 'lb.eject'
    # Fleet request tracing (serve/load_balancer.py): one event per
    # proxy hop inside the LB-side `lb.proxy` span — candidate
    # selection (with the circuit-breaker ejections traversed) and each
    # failover hop — journaled under the request's own trace id
    # (X-Request-Id), so `skytpu trace <request-id>` shows WHICH
    # replicas a request tried before it was answered.
    LB_HOP = 'lb.hop'
    # Fleet SLO rollup (observability/slo.py): a replica whose TTFT p95
    # deviates from the fleet median past the straggler threshold is
    # journaled on the flag TRANSITION (and again when it recovers),
    # with the evidence; the LB also feeds the flag to its circuit
    # breaker as a soft signal.
    REPLICA_STRAGGLER = 'replica.straggler'
    # Tensor-parallel serving (models/engine.py): journaled once at
    # engine start with the GSPMD mesh shape + device kinds, so perf
    # rounds and postmortems can attribute throughput to the topology
    # that served it.
    ENGINE_MESH = 'engine.mesh'
    # HBM accounting (models/engine.py): journaled once at engine start
    # beside engine.mesh — per-device weights vs KV-pool vs workspace
    # bytes on the serving mesh (also the skytpu_engine_hbm_bytes{kind}
    # gauges), so "what is eating this replica's HBM" is answerable
    # without a device debugger.
    ENGINE_HBM = 'engine.hbm'
    # Prefix-aware routing (serve/load_balancer.py): one event per
    # digest-keyed routing decision — the consistent-hash owner, and
    # whether the request landed on it (affinity hit) or was rehashed
    # away (excluded replica / load bound / saturated fleet) — nested
    # under the request's lb.proxy span.
    LB_ROUTE = 'lb.route'
    # Cross-replica prefix cache tier (models/engine.py): an admission
    # that radix-missed locally and consulted a peer (the LB-advertised
    # owner or SKYTPU_PREFIX_PEERS) journals the outcome — blocks
    # fetched and injected, miss, dtype/shape mismatch, or budget
    # exhaustion degrading to plain prefill.
    ENGINE_PREFIX_FETCH = 'engine.prefix_fetch'
    # Disaggregated prefill/decode (models/engine.py): a prefill-tier
    # admission streaming its KV blocks to a decode-tier peer journals
    # the handoff outcome — complete (all aligned blocks acked, slot
    # freed), degraded (push failure / peer backoff / truncated stream:
    # decode-in-place on the prefill replica), and the decode side's
    # injection result — so "who served this request's tokens" is
    # answerable per handoff.
    ENGINE_HANDOFF = 'engine.handoff'
    # Durable fleet KV cache (models/block_store.py): a cold-miss
    # admission that also missed its peers consulted the persistent
    # block store; the outcome (blocks fetched and injected, store
    # miss, mismatch rejection, store down → plain prefill) journals
    # under the request's trace id beside engine.prefix_fetch.
    ENGINE_STORE_FETCH = 'engine.store_fetch'
    # Write-behind spill (models/engine.py → block_store): an owner
    # that published a new radix run persisted it to the store (or
    # failed to, entering backoff) — so "which prefixes survive a
    # fleet restart" is answerable from the journal.
    STORE_SPILL = 'store.spill'
    # Digest-aware autoscaling (serve/autoscalers.py + controller):
    # a scale-up triggered by hot digest-family load journals the
    # family evidence, and a joining replica pre-warmed from the
    # store (POST /prewarm) journals the digests it warmed.
    AUTOSCALE_PREWARM = 'autoscale.prewarm'
    # Journal-plane self-observability (this module): a JournalBuffer
    # flush that blew past SKYTPU_JOURNAL_STALL_SECONDS journals ONE row
    # when writes recover — written via the direct (unbuffered,
    # un-chaos'd) path so a stalled journal can never recurse into
    # reporting its own stall.
    JOURNAL_STALL = 'journal.stall'


KINDS = frozenset(k.value for k in EventKind)

_TABLE = """
    PRAGMA journal_mode=WAL;
    PRAGMA synchronous=NORMAL;
    CREATE TABLE IF NOT EXISTS events (
        event_id INTEGER PRIMARY KEY AUTOINCREMENT,
        ts REAL,
        kind TEXT,
        entity TEXT,
        payload TEXT,
        trace_id TEXT,
        span_id TEXT,
        parent_span_id TEXT
    );
    CREATE INDEX IF NOT EXISTS idx_events_trace ON events(trace_id);
    CREATE INDEX IF NOT EXISTS idx_events_entity ON events(entity);
"""


def db_path() -> str:
    override = os.environ.get(DB_PATH_ENV)
    if override:
        return os.path.expanduser(override)
    return os.path.join(os.path.expanduser('~'), '.skytpu', 'journal.db')


# WAL + synchronous=NORMAL (in the schema script above): a commit appends
# to the write-ahead log instead of rewriting the main DB — on network
# filesystems this is the difference between ~200ms and sub-ms per write,
# and the durability trade (an OS crash may lose the tail of the log) is
# exactly the journal's documented best-effort contract.


_CONN = db_utils.SqliteConn('journal', db_path, _TABLE)
# Explicit-path connections (the ``db_path=`` parameter threaded through
# event/event_batch/query): one SqliteConn per resolved path, so several
# in-process instances can journal to separate files concurrently.
_conns_lock = threading.Lock()
_CONNS: Dict[str, db_utils.SqliteConn] = {}


def _db(db_path_override: Optional[str] = None) -> sqlite3.Connection:
    if not db_path_override:
        return _CONN.get()
    resolved = os.path.abspath(os.path.expanduser(db_path_override))
    with _conns_lock:
        conn = _CONNS.get(resolved)
        if conn is None:
            conn = _CONNS[resolved] = db_utils.SqliteConn(
                f'journal@{resolved}', lambda p=resolved: p, _TABLE)
    return conn.get()


def max_events() -> int:
    try:
        return int(os.environ.get(MAX_EVENTS_ENV, DEFAULT_MAX_EVENTS))
    except ValueError:
        return DEFAULT_MAX_EVENTS


def queue_depth() -> int:
    """JournalBuffer bound (re-read per call: tests shrink it to force
    the drop path without thousands of appends)."""
    try:
        return int(os.environ.get(QUEUE_DEPTH_ENV, DEFAULT_QUEUE_DEPTH))
    except ValueError:
        return DEFAULT_QUEUE_DEPTH


def stall_seconds() -> float:
    try:
        return float(os.environ.get(STALL_SECONDS_ENV,
                                    str(DEFAULT_STALL_SECONDS)))
    except ValueError:
        return DEFAULT_STALL_SECONDS


def query_limit() -> int:
    """Hard per-call row cap for the /journal query endpoints."""
    try:
        return int(os.environ.get(QUERY_LIMIT_ENV, DEFAULT_QUERY_LIMIT))
    except ValueError:
        return DEFAULT_QUERY_LIMIT


def enabled() -> bool:
    return os.environ.get(DISABLE_ENV, '0') != '1'


def kind_writable(kind_value: str) -> bool:
    """Whether this kind passes the ONLY_KINDS filter (always True when
    the env is unset). Re-read per call: the bench toggles it around
    measured passes."""
    only = os.environ.get(ONLY_KINDS_ENV, '')
    if not only:
        return True
    return kind_value in {k.strip() for k in only.split(',') if k.strip()}


def event(kind: Union[EventKind, str],
          entity: str,
          payload: Optional[Dict[str, Any]] = None,
          *,
          trace_id: Optional[str] = None,
          span_id: Optional[str] = None,
          parent_span_id: Optional[str] = None,
          ts: Optional[float] = None,
          db_path: Optional[str] = None) -> None:
    """Append one event. Trace/span default to the ambient context
    (``observability/trace``); entity is a ``type:name`` string, e.g.
    ``cluster:train-1-0``, ``job:3``, ``replica:svc/2``. ``db_path``
    targets an explicit journal file (defaults to this host's)."""
    kind_value = kind.value if isinstance(kind, EventKind) else str(kind)
    if kind_value not in KINDS:
        raise ValueError(
            f'Unregistered journal event kind {kind_value!r}; add it to '
            'observability.journal.EventKind first.')
    if not enabled() or not kind_writable(kind_value):
        return
    trace_id = trace_id or trace_lib.get_trace_id()
    span_id = span_id or trace_lib.get_span_id()
    if parent_span_id is None:
        parent_span_id = trace_lib.get_parent_span_id()
    try:
        with _db(db_path) as conn:
            cur = conn.execute(
                'INSERT INTO events (ts, kind, entity, payload, trace_id, '
                'span_id, parent_span_id) VALUES (?,?,?,?,?,?,?)',
                (time.time() if ts is None else ts, kind_value,
                 entity or '', json.dumps(payload or {}, default=str),
                 trace_id, span_id, parent_span_id))
            # Rowid-window prune: O(1) via the PK index, no ORDER BY
            # scan. job.phase rows are exempt — the goodput integral is
            # recomputed from them, and letting chatty span/provision
            # traffic evict a long-lived job's early phase events would
            # silently shrink its phase_seconds. They get their own much
            # larger cap below (they are low-volume: a handful per
            # transition, not per poll).
            cap = max_events()
            if cur.lastrowid is not None and cur.lastrowid > cap:
                conn.execute(
                    'DELETE FROM events WHERE event_id <= ? AND '
                    'kind != ?',
                    (cur.lastrowid - cap, EventKind.JOB_PHASE.value))
            if kind_value == EventKind.JOB_PHASE.value:
                conn.execute(
                    'DELETE FROM events WHERE kind = ? AND event_id '
                    'NOT IN (SELECT event_id FROM events WHERE kind = ? '
                    'ORDER BY event_id DESC LIMIT ?)',
                    (kind_value, kind_value, PHASE_EVENTS_CAP))
    except (sqlite3.Error, OSError):
        pass  # the flight recorder must never take the plane down


def event_batch(items: Sequence[tuple],
                db_path: Optional[str] = None) -> int:
    """Append many events in ONE transaction (one fsync) — the hot-path
    form. Per-event ``event()`` pays a commit per call, which is fine at
    control-plane rates; a serving engine journaling admissions and
    evictions per scheduling tick uses this instead (models/engine.py
    buffers and flushes per tick).

    Returns the number of rows committed (filtered/disabled rows are not
    counted — they were dropped by policy, not lost), or ``-1`` when the
    transaction failed (sqlite/OS error): one transaction means the
    WHOLE batch was lost, which the JournalBuffer counts as
    ``write_error`` drops.

    Each item is ``(kind, entity, payload, ts)`` — ts stamped by the
    caller at buffer time, so batching does not skew the timeline.
    Trace context is resolved once at write time (the buffering caller
    is single-threaded per engine loop, so ambient context is stable).
    An optional fifth element overrides the trace context for THAT row:
    a bare string overrides the trace id (span/parent nulled — the
    pre-fleet-tracing form), and a ``(trace_id, span_id,
    parent_span_id)`` tuple overrides all three — the engine stamps
    request-scoped events (admit/evict/slow_request) with the request's
    own trace id (the server's ``X-Request-Id``) AND the server-side
    request span, so ``skytpu trace <request-id>`` reconstructs one
    request's timeline nested under the HTTP spans that carried it.
    """
    if not items:
        return 0
    rows = []
    for item in items:
        kind, entity, payload, ts = item[:4]
        override = item[4] if len(item) > 4 else None
        kind_value = (kind.value if isinstance(kind, EventKind)
                      else str(kind))
        if kind_value not in KINDS:
            raise ValueError(
                f'Unregistered journal event kind {kind_value!r}; add it '
                'to observability.journal.EventKind first.')
        if isinstance(override, (tuple, list)):
            row_ctx = (tuple(override) + (None, None, None))[:3]
        elif override:
            row_ctx = (override, None, None)
        else:
            row_ctx = None
        if not kind_writable(kind_value):
            continue
        rows.append((ts, kind_value, entity or '',
                     json.dumps(payload or {}, default=str), row_ctx))
    if not enabled() or not rows:
        return 0
    trace_id = trace_lib.get_trace_id()
    span_id = trace_lib.get_span_id()
    parent = trace_lib.get_parent_span_id()
    try:
        with _db(db_path) as conn:
            cur = None
            for ts, kind_value, entity, payload_json, row_ctx in rows:
                cur = conn.execute(
                    'INSERT INTO events (ts, kind, entity, payload, '
                    'trace_id, span_id, parent_span_id) '
                    'VALUES (?,?,?,?,?,?,?)',
                    (ts, kind_value, entity, payload_json,
                     row_ctx[0] if row_ctx else trace_id,
                     row_ctx[1] if row_ctx else span_id,
                     row_ctx[2] if row_ctx else parent))
            cap = max_events()
            if cur is not None and cur.lastrowid is not None \
                    and cur.lastrowid > cap:
                conn.execute(
                    'DELETE FROM events WHERE event_id <= ? AND '
                    'kind != ?',
                    (cur.lastrowid - cap, EventKind.JOB_PHASE.value))
    except (sqlite3.Error, OSError):
        return -1  # the flight recorder must never take the plane down
    return len(rows)


class JournalBuffer:
    """Bounded, lock-guarded buffer of :func:`event_batch` rows for
    hot-path writers (the decode engine's tick loop, the LB's proxy
    handler): appends are lock+list-append cheap and NEVER block on the
    database — at ``SKYTPU_JOURNAL_QUEUE_DEPTH`` the row is dropped and
    counted (``skytpu_journal_dropped_total{reason="queue_full"}``)
    instead of growing without bound behind a stalled disk. One
    ``flush()`` writes the whole batch in a single transaction;
    ``flush(wait=False)`` hands the write to a short-lived background
    thread so the engine step loop never sits behind an fsync. The
    optional ``override`` per row is event_batch's fifth element (a
    trace-id string or a ``(trace, span, parent)`` tuple).

    The buffer observes itself: flush latency/batch counters feed the
    ``skytpu_journal_*`` self-metrics and :meth:`stats`, and a flush
    slower than ``SKYTPU_JOURNAL_STALL_SECONDS`` journals ONE
    ``journal.stall`` row on recovery (via the direct, unbuffered write
    path — reporting a stall must not re-enter the stalled path).
    """

    # Lock discipline: appenders race the flusher; the
    # self-accounting counters ride the same lock. Metric increments and
    # the actual sqlite write happen OUTSIDE the lock — a wedged journal
    # write must never wedge appenders.
    _GUARDED_BY = {
        '_buf': '_lock',
        '_appended': '_lock',
        '_written': '_lock',
        '_dropped_queue_full': '_lock',
        '_dropped_write_error': '_lock',
        '_flushes': '_lock',
        '_flush_secs': '_lock',
        '_pending_stall': '_lock',
        '_async_inflight': '_lock',
        '_async_pending': '_lock',
    }

    # Flush-latency ring for the stats() p95 (not a full histogram —
    # the registry metric has the buckets).
    _FLUSH_RING = 256

    def __init__(self, db_path: Optional[str] = None,
                 entity: str = 'journal'):
        self._lock = threading.Lock()
        # Serializes _flush_once bodies: a flush(wait=True) must not
        # return while an async flush that already claimed rows is
        # still committing them, or "flush then read" callers miss the
        # tail of the batch. Never held while taking _lock-only paths'
        # callers (append stays lock-cheap and never touches it).
        self._write_lock = threading.Lock()
        self._buf: List[tuple] = []
        self._db_path = db_path
        self._entity = entity
        self._appended = 0
        self._written = 0
        self._dropped_queue_full = 0
        self._dropped_write_error = 0
        self._flushes = 0
        self._flush_secs: List[float] = []
        self._pending_stall: Optional[Dict[str, Any]] = None
        self._async_inflight = False
        self._async_pending = False

    @property
    def db_path(self) -> Optional[str]:
        return self._db_path

    def append(self, kind, entity: str, payload: Optional[Dict[str, Any]],
               override=None, ts: Optional[float] = None) -> bool:
        """Buffer one row. Returns False when the bounded queue was full
        and the row was dropped (counted, never blocking)."""
        row = (kind, entity, payload,
               time.time() if ts is None else ts, override)
        with self._lock:
            if len(self._buf) >= queue_depth():
                self._dropped_queue_full += 1
                dropped = True
            else:
                self._buf.append(row)
                self._appended += 1
                dropped = False
        if dropped:
            # Outside the buffer lock: the registry takes its own locks
            # and the drop path must never hold ours while doing so.
            metrics_lib.counter(
                'skytpu_journal_dropped_total',
                'Journal rows lost (bounded queue full, or a failed '
                'batch transaction).',
                labels=('reason',)).inc(labels=('queue_full',))
        return not dropped

    def flush(self, wait: bool = True) -> None:
        """Write buffered rows. ``wait=True`` (teardown, stats, tests)
        blocks until the batch is committed; ``wait=False`` (the engine
        step loop) schedules the write on a short-lived daemon thread
        and returns immediately — concurrent calls coalesce, so a flush
        stalled behind a wedged disk queues at most one follow-up."""
        if wait:
            self._flush_once()
            return
        with self._lock:
            if self._async_inflight:
                self._async_pending = True
                return
            self._async_inflight = True
        threading.Thread(target=self._async_flush,
                         name='journal-flush', daemon=True).start()

    def _async_flush(self) -> None:
        while True:
            self._flush_once()
            with self._lock:
                if not self._async_pending:
                    self._async_inflight = False
                    return
                self._async_pending = False

    def _flush_once(self) -> None:
        # Taken before rows are claimed and held through the commit:
        # once a sync flush acquires it, every row claimed by an
        # earlier (possibly async) flush is already durable.
        with self._write_lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        t0 = time.monotonic()
        if chaos.should_fire('journal_write_stall'):
            time.sleep(chaos.journal_stall_seconds())
        if chaos.should_fire('journal_disk_full'):
            written = -1
        else:
            written = event_batch(buf, db_path=self._db_path)
        dt = time.monotonic() - t0
        stall_note = None
        with self._lock:
            self._flushes += 1
            self._flush_secs.append(dt)
            del self._flush_secs[:-self._FLUSH_RING]
            if written < 0:
                self._dropped_write_error += len(buf)
            else:
                self._written += written
            if dt >= stall_seconds():
                note = self._pending_stall or {'stall_seconds': 0.0,
                                               'stalled_flushes': 0}
                note['stall_seconds'] = max(note['stall_seconds'], dt)
                note['stalled_flushes'] += 1
                self._pending_stall = note
            elif self._pending_stall is not None:
                # Recovery: this flush was fast again.
                stall_note = self._pending_stall
                self._pending_stall = None
                stall_note['dropped_queue_full'] = self._dropped_queue_full
                stall_note['dropped_write_error'] = \
                    self._dropped_write_error
        metrics_lib.histogram(
            'skytpu_journal_flush_seconds',
            'JournalBuffer batch-commit latency.').observe(dt)
        if written > 0:
            metrics_lib.counter(
                'skytpu_journal_events_total',
                'Journal rows committed through the buffered '
                'path.').inc(written)
        elif written < 0:
            metrics_lib.counter(
                'skytpu_journal_dropped_total',
                'Journal rows lost (bounded queue full, or a failed '
                'batch transaction).',
                labels=('reason',)).inc(len(buf),
                                        labels=('write_error',))
        if stall_note is not None:
            # Direct synchronous write, NOT through this buffer and not
            # through the chaos'd batch path — cannot recurse.
            event(EventKind.JOURNAL_STALL, self._entity, stall_note,
                  db_path=self._db_path)

    def stats(self) -> Dict[str, Any]:
        """Self-observability snapshot (the bench detail block and the
        engine's journal_stats surface)."""
        with self._lock:
            secs = sorted(self._flush_secs)
            p95 = secs[int(0.95 * (len(secs) - 1))] if secs else 0.0
            return {
                'buffered': len(self._buf),
                'appended': self._appended,
                'written': self._written,
                'dropped_queue_full': self._dropped_queue_full,
                'dropped_write_error': self._dropped_write_error,
                'dropped': (self._dropped_queue_full
                            + self._dropped_write_error),
                'flushes': self._flushes,
                'flush_p95_seconds': p95,
            }


def query(kinds: Optional[Sequence[Union[EventKind, str]]] = None,
          entity: Optional[str] = None,
          entity_prefix: Optional[str] = None,
          trace_id: Optional[str] = None,
          since_id: Optional[int] = None,
          limit: int = 200,
          ascending: bool = False,
          db_path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Read events, newest first by default (``ascending=True`` for
    timeline/trace rendering). Payloads come back as dicts."""
    clauses, args = [], []
    if kinds:
        values = [k.value if isinstance(k, EventKind) else str(k)
                  for k in kinds]
        clauses.append(
            f'kind IN ({",".join("?" * len(values))})')
        args.extend(values)
    if entity is not None:
        clauses.append('entity = ?')
        args.append(entity)
    if entity_prefix is not None:
        # Escape LIKE wildcards: entities legitimately contain '_'.
        escaped = (entity_prefix.replace('\\', '\\\\')
                   .replace('%', '\\%').replace('_', '\\_'))
        clauses.append("entity LIKE ? ESCAPE '\\'")
        args.append(escaped + '%')
    if trace_id is not None:
        clauses.append('trace_id = ?')
        args.append(trace_id)
    if since_id is not None:
        clauses.append('event_id > ?')
        args.append(since_id)
    where = f' WHERE {" AND ".join(clauses)}' if clauses else ''
    order = 'ASC' if ascending else 'DESC'
    try:
        rows = _db(db_path).execute(
            f'SELECT * FROM events{where} ORDER BY event_id {order} '
            'LIMIT ?', (*args, limit)).fetchall()
    except (sqlite3.Error, OSError):
        return []
    out = []
    for r in rows:
        d = dict(r)
        try:
            d['payload'] = json.loads(d['payload'] or '{}')
        except ValueError:
            d['payload'] = {}
        out.append(d)
    return out


def serve_query(params: Dict[str, Any],
                db_path: Optional[str] = None,
                host: str = '') -> Dict[str, Any]:
    """The /journal query endpoint, shared by the model server, the LB,
    and the API server: filter (trace id, kinds, entity/prefix,
    since-rowid cursor) + a hard ``SKYTPU_JOURNAL_QUERY_LIMIT`` row cap
    per call. Unknown kinds are filtered out and malformed values
    degrade to defaults — the journal read plane must not 500 on a
    typo'd cursor. Rows come back oldest-first within the page;
    ``next_since_id`` is the resume cursor for the federation poll
    (``skytpu events --since``)."""
    def _int(key: str) -> Optional[int]:
        try:
            return int(params[key])
        except (KeyError, TypeError, ValueError):
            return None

    kinds = params.get('kinds')
    if isinstance(kinds, str):
        kinds = [k.strip() for k in kinds.split(',') if k.strip()]
    kinds = [k for k in (kinds or []) if k in KINDS] or None
    cap = query_limit()
    limit = _int('limit')
    limit = cap if limit is None else max(1, min(limit, cap))
    since_id = _int('since_id')
    trace_id = params.get('trace_id') or params.get('trace') or None
    # A cursor pull pages oldest-first (resumable); the initial pull
    # serves the NEWEST rows (what `events` shows), re-sorted so the
    # page itself always reads oldest-first.
    ascending = since_id is not None or trace_id is not None
    rows = query(kinds=kinds,
                 entity=params.get('entity') or None,
                 entity_prefix=params.get('entity_prefix') or None,
                 trace_id=trace_id, since_id=since_id, limit=limit,
                 ascending=ascending, db_path=db_path)
    if not ascending:
        rows.reverse()
    return {
        'host': host,
        'count': len(rows),
        'events': rows,
        'next_since_id': max((r['event_id'] for r in rows),
                             default=since_id or 0),
    }


def resolve_trace_prefix(prefix: str,
                         db_path: Optional[str] = None) -> List[str]:
    """Full trace ids matching a prefix — resolved in SQL so even traces
    whose events sit deep in the journal are found (`skytpu events`
    prints 8-char prefixes)."""
    escaped = (prefix.replace('\\', '\\\\')
               .replace('%', '\\%').replace('_', '\\_'))
    try:
        rows = _db(db_path).execute(
            "SELECT DISTINCT trace_id FROM events WHERE trace_id "
            "LIKE ? ESCAPE '\\'", (escaped + '%',)).fetchall()
    except (sqlite3.Error, OSError):
        return []
    return sorted(r['trace_id'] for r in rows if r['trace_id'])
