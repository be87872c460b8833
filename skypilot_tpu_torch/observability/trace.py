"""Trace context for the replica: trace/span ids and the HTTP hop headers.

This package's copy of the parts of ``skypilot_tpu/observability/trace.py``
the model server and the journal use. One *trace* covers one logical
operation end to end (one ``/generate`` request, joined across the load
balancer → replica HTTP → engine hops); within it, *spans* nest, and
every journal row records the (trace, span, parent) triple it fired
under, so a reader can rebuild the tree afterwards.

In-process context rides ``contextvars``; across processes the
``SKYTPU_TRACE_ID`` / ``SKYTPU_SPAN_ID`` env vars (``get_trace_id``
falls back to the env). Ids are opaque hex; the journal is the only
consumer.
"""
import contextvars
import os
import uuid
from typing import Optional

TRACE_ID_ENV = 'SKYTPU_TRACE_ID'
SPAN_ID_ENV = 'SKYTPU_SPAN_ID'

# HTTP hop propagation: the load balancer mints/forwards these on every
# proxied request and the model server joins the carried context instead
# of starting a fresh trace. X-Request-Id doubles as the trace id; the
# span header carries the upstream hop's span id so the replica's
# server.request span parents under it.
REQUEST_ID_HEADER = 'X-Request-Id'
TRACE_ID_HEADER = 'X-Skytpu-Trace-Id'
SPAN_ID_HEADER = 'X-Skytpu-Span-Id'
# Prefix-affinity routing: the load balancer names the prefix owner it
# rehashed a request away from (the engine keeps it as the request's
# prefix_hint).
PREFIX_OWNER_HEADER = 'X-Skytpu-Prefix-Owner'
# Disaggregated prefill/decode: the load balancer names the decode
# replica a /prefill_handoff streams the request's KV blocks to (the
# replica honours it only within its configured peers).
HANDOFF_TARGET_HEADER = 'X-Skytpu-Handoff-Target'

_trace_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    'skytpu_trace_id', default=None)
_span_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    'skytpu_span_id', default=None)
_parent_span_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar('skytpu_parent_span_id', default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def get_trace_id() -> Optional[str]:
    """Active trace id: contextvar first, then the inherited env."""
    return _trace_id.get() or os.environ.get(TRACE_ID_ENV) or None


def get_span_id() -> Optional[str]:
    return _span_id.get() or os.environ.get(SPAN_ID_ENV) or None


def get_parent_span_id() -> Optional[str]:
    # The env carries only (trace, span): a spawned process knows which
    # span it runs under but not that span's own parent.
    return _parent_span_id.get()


def attach(trace_id: Optional[str],
           span_id: Optional[str] = None) -> None:
    """Adopt a persisted trace context (process start from a stored
    row)."""
    if trace_id:
        _trace_id.set(trace_id)
    if span_id:
        _span_id.set(span_id)


def ensure_trace() -> str:
    """Return the active trace id, starting a new trace if none."""
    tid = get_trace_id()
    if tid is None:
        tid = new_trace_id()
        _trace_id.set(tid)
    return tid
