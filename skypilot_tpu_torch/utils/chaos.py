"""Env-driven fault injection for the serving plane.

This package's copy of ``skypilot_tpu/utils/chaos.py``, with the same
parsing and firing rules. One env var arms everything::

    SKYTPU_CHAOS=engine_step_raise:2,slow_step:0.5,drain_hang,replica_500:0.3

Comma-separated ``point[:arg]`` specs. The arg's shape selects the
firing mode:

* **counted** (``engine_step_raise:2``, an integer): the point fires
  that many times in this process, then disarms. Re-arm by changing the
  env value (or :func:`reset` in tests).
* **probabilistic** (``replica_500:0.3``, a float with a ``.``): each
  check fires independently with that probability (``1.0`` = always).
* **bare** (``drain_hang``): fires on every check while armed.

Points the port checks:

=====================  ====================================================
``engine_step_raise``  ``DecodeEngine.step()`` raises :class:`ChaosError`
                       (the supervisor's crash, fail in-flight, rebuild,
                       restart path).
``slow_step``          ``step()`` sleeps ``SKYTPU_CHAOS_SLOW_STEP_SECONDS``
                       (default 0.2) first: stall detection, drain-under-
                       load windows.
``drain_hang``         the model server's drain never sees the engine
                       idle, so it rides out ``SKYTPU_DRAIN_TIMEOUT_SECONDS``.
``replica_500``        the model server answers ``/generate`` with a 500
                       before touching the engine.
``handoff_decode_death``  the decode replica "dies" mid-handoff:
                       ``DecodeEngine.inject_handoff_blocks`` raises
                       :class:`ChaosError` before touching the pool, so
                       the prefill side's push fails and the request
                       degrades to decode-in-place (answered, never
                       hung).
``handoff_truncate``   the prefill side's ``prefix_transfer.http_push``
                       ships only half the serialised block payload: the
                       decode side rejects the malformed body and the
                       prefill side degrades.
``journal_write_stall``  ``JournalBuffer`` batch commits sleep
                       ``SKYTPU_CHAOS_JOURNAL_STALL_SECONDS`` (default
                       2.0) first: a wedged journal disk. The bounded
                       buffer must keep the engine step loop
                       non-blocking (drops counted, one ``journal.stall``
                       row on recovery).
``journal_disk_full``  ``JournalBuffer`` batch commits fail outright: the
                       whole batch is counted as ``write_error`` drops.
=====================  ====================================================

The reference's other points (``store_down``, ``store_torn_entry``,
``store_slow``) belong to the block store, which the port does not have
yet. With ``SKYTPU_CHAOS`` unset every check is one dict lookup
returning False.
"""
import os
import random
import threading
import time
from typing import Dict, Optional

CHAOS_ENV = 'SKYTPU_CHAOS'
SLOW_STEP_SECONDS_ENV = 'SKYTPU_CHAOS_SLOW_STEP_SECONDS'
DEFAULT_SLOW_STEP_SECONDS = 0.2
JOURNAL_STALL_SECONDS_ENV = 'SKYTPU_CHAOS_JOURNAL_STALL_SECONDS'
DEFAULT_JOURNAL_STALL_SECONDS = 2.0


class ChaosError(RuntimeError):
    """Injected failure (see SKYTPU_CHAOS)."""


# Counted points keep process-local state (remaining fires), re-armed
# whenever the env's raw arg for that point changes.
_lock = threading.Lock()
_counts: Dict[str, int] = {}          # point -> remaining fires
_count_src: Dict[str, str] = {}       # point -> raw arg it was armed from


def _spec() -> Dict[str, Optional[str]]:
    """Parse SKYTPU_CHAOS (re-read per call, so a live process can be
    armed without a restart). Malformed entries are ignored."""
    raw = os.environ.get(CHAOS_ENV)
    if not raw:
        return {}
    out: Dict[str, Optional[str]] = {}
    for part in raw.split(','):
        part = part.strip()
        if not part:
            continue
        point, _, arg = part.partition(':')
        point = point.strip()
        if point:
            out[point] = arg.strip() if arg else None
    return out


def reset() -> None:
    """Drop counted-point state (tests)."""
    with _lock:
        _counts.clear()
        _count_src.clear()


def armed(point: str) -> bool:
    """Is the point present in SKYTPU_CHAOS at all (a counted point stays
    armed after its budget is spent; :func:`should_fire` consumes)?"""
    return point in _spec()


def should_fire(point: str) -> bool:
    """One chaos check. Counted specs consume a fire; probabilistic
    specs roll independently; bare specs always fire."""
    spec = _spec()
    if point not in spec:
        return False
    arg = spec[point]
    if arg is None:
        return True
    if '.' in arg:
        try:
            return random.random() < float(arg)
        except ValueError:
            return False
    try:
        total = int(arg)
    except ValueError:
        return False
    with _lock:
        if _count_src.get(point) != arg:
            _count_src[point] = arg
            _counts[point] = total
        if _counts.get(point, 0) <= 0:
            return False
        _counts[point] -= 1
        return True


def maybe_raise(point: str) -> None:
    """Raise :class:`ChaosError` when the point fires."""
    if should_fire(point):
        raise ChaosError(f'chaos: injected {point} ({CHAOS_ENV})')


def slow_step_seconds() -> float:
    try:
        return float(os.environ.get(SLOW_STEP_SECONDS_ENV,
                                    str(DEFAULT_SLOW_STEP_SECONDS)))
    except ValueError:
        return DEFAULT_SLOW_STEP_SECONDS


def maybe_slow_step() -> None:
    """Sleep the configured delay when ``slow_step`` fires."""
    if should_fire('slow_step'):
        time.sleep(slow_step_seconds())


def journal_stall_seconds() -> float:
    """How long a fired ``journal_write_stall`` wedges one batch commit."""
    try:
        return float(os.environ.get(JOURNAL_STALL_SECONDS_ENV,
                                    str(DEFAULT_JOURNAL_STALL_SECONDS)))
    except ValueError:
        return DEFAULT_JOURNAL_STALL_SECONDS
