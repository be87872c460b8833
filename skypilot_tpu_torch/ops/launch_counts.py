"""The kernel wrappers' launch counters (``fn.launches``, a plain int).

Each wrapper calls :func:`count` where it launches its kernel, so a run
can show that the serving or training path went through the kernel.
A CUDA-graph capture runs the wrappers but enqueues nothing: while a
thread captures (:func:`recording`), its counts go to the recording
instead of the counters, and each replay of the graph adds them
(:func:`add`; ``models/cuda_graphs.py``). The recording is per thread,
so another engine's launches during a capture are counted as usual,
and one lock keeps the counters exact across engine threads.
"""
import contextlib
import threading
from typing import Callable, Dict, Iterator

_lock = threading.Lock()
_local = threading.local()


def count(fn: Callable) -> None:
    """One launch of ``fn``'s kernel: recorded while this thread
    captures, else added to ``fn.launches``."""
    rec = getattr(_local, 'recording', None)
    if rec is not None:
        rec[fn] = rec.get(fn, 0) + 1
        return
    with _lock:
        fn.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[Callable, int]]:
    """This thread's launches inside the block, by wrapper, held apart
    from the counters (a capture's)."""
    prev = getattr(_local, 'recording', None)
    rec: Dict[Callable, int] = {}
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = prev


def add(deltas: Dict[Callable, int]) -> None:
    """The launches of one replay of a captured graph."""
    with _lock:
        for fn, n in deltas.items():
            fn.launches += n
