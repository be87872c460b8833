"""The engine's compiled dispatches: one CUDA graph per dispatch shape.

The reference runs each engine round as one jitted call with the cache
donated (``skypilot_tpu/models/engine.py`` ``_engine_steps_impl``,
``_engine_paged_steps_impl``, ``_engine_spec_step_impl``;
``skypilot_tpu/models/decode.py`` ``paged_prefill`` and
``paged_prefill_with_prefix``): XLA traces a dispatch once per static
shape and later calls run the compiled program. ``jax.jit`` is this
module's counterpart, so the JAX package has no module like it. Here a
dispatch of a new key runs eagerly for real (the warm-up), is captured
into a CUDA graph right after, and every later dispatch of that key is
one replay. :class:`~skypilot_tpu_torch.models.engine.DecodeEngine`
keys its decode rounds, spec steps, paged prefills and dense inserts
through one :class:`GraphCache`, and each
:class:`~skypilot_tpu_torch.models.decode.GenerateProgram` (the static
``decode.generate``, the reference's ``_generate_impl``) its prefill and
decode-step rounds through one of its own.

* **Fixed addresses.** A graph reads and writes the addresses it was
  captured with: the pool and the engine's static input buffers, which
  the engine fills before each dispatch. The caller passes their
  ``data_ptr``s with every dispatch; a replay whose pointers differ from
  the capture's raises, and is never silently captured again.
* **Launch counts.** A capture runs the kernel wrappers but enqueues
  nothing, so their counts during the capture are recorded
  (``ops/launch_counts.recording``), never added, and every replay adds
  them.
* **One pool, one stream.** Every graph of a cache allocates from one
  ``torch.cuda.graph_pool_handle()`` and they replay one after another
  on the caller's stream, so a dispatch's outputs are valid until the
  next dispatch of any key: the engine reads each before the next. The
  warm-up and the capture run on the process's capture stream.
* **Sampling.** The engine's ``torch.Generator`` is registered with every
  graph, so a replayed round draws fresh noise from it, as an eager one
  does.
* **Invalidation.** :meth:`GraphCache.reset` drops every graph and the
  pool: the supervisor's rebuild allocates a new pool, and the next
  dispatch of each key captures again.
"""
import collections
import threading
import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.ops import launch_counts

# How compiled dispatches run on the card: one CUDA-graph replay per
# dispatch ('graph'), or eagerly ('eager', for comparisons). The CPU
# always runs them eagerly.
ROUNDS = ('graph', 'eager')
# Captures are rare (one per key) and touch process-wide CUDA state (the
# caching allocator, the device synchronise that opens a capture, the
# shared capture stream below), so the engines of one process warm up
# and capture one at a time.
_CAPTURE_LOCK = threading.Lock()
# One capture stream a device for the process, as torch.cuda.graph's own
# default: cuBLAS keeps a workspace for each (handle, stream) it sees,
# allocated at the first GEMM there, which the warm-up runs outside any
# capture. A stream per engine would leave one workspace per engine.
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> 'torch.cuda.Stream':
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class CudaCapturer:
    """Warm-up and capture on the process's capture stream, into one
    graph pool, in ``thread_local`` error mode (the engine captures on
    its loop thread while the server's threads run beside it)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self._generator = generator
        self.pool = None

    def reset(self) -> None:
        """A new pool: the old one is freed with the graphs that hold it."""
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``fn()`` for real, on the capture stream, ordered after and
        before the caller's stream: the dispatch's first run, which also
        allocates what a GEMM keeps per stream before any capture."""
        stream = _capture_stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = fn()
        caller.wait_stream(stream)
        out.record_stream(caller)
        return out

    def capture(self, fn: Callable[[], torch.Tensor]):
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        with torch.cuda.graph(graph, pool=self.pool,
                              stream=_capture_stream(self.device),
                              capture_error_mode='thread_local'):
            out = fn()
        return graph, out

    def pool_bytes(self) -> Tuple[int, int]:
        """(reserved, allocated) bytes of the pool's segments."""
        reserved = allocated = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get('segment_pool_id', ())) == tuple(self.pool):
                reserved += seg['total_size']
                allocated += seg['allocated_size']
        return reserved, allocated


class GraphCache:
    """One captured graph per dispatch key, replayed from then on. The
    capturer is :class:`CudaCapturer` on the card; the CPU tests hand in
    a stand-in with the same ``reset``/``warm_up``/``capture``/
    ``pool_bytes``."""

    def __init__(self, capturer):
        self._capturer = capturer
        self._graphs: Dict[Hashable, tuple] = {}
        self.captures: collections.Counter = collections.Counter()
        self.capture_seconds = 0.0
        self.replays = 0
        capturer.reset()

    def run(self, key: Tuple, fn: Callable[[], torch.Tensor],
            ptrs: Tuple[int, ...]) -> torch.Tensor:
        """``fn()``'s result for dispatch ``key`` (a tuple whose first
        item is the dispatch's kind). The first dispatch of a key runs
        ``fn`` for real and then captures it; later ones replay. ``ptrs``
        are the addresses ``fn`` reads and writes."""
        entry = self._graphs.get(key)
        if entry is None:
            with _CAPTURE_LOCK:
                out = self._capturer.warm_up(fn)
                t0 = time.perf_counter()
                with launch_counts.recording() as deltas:
                    graph, static_out = self._capturer.capture(fn)
                self.capture_seconds += time.perf_counter() - t0
            self.captures[key[0]] += 1
            self._graphs[key] = (graph, static_out, deltas, ptrs)
            return out
        graph, static_out, deltas, captured = entry
        if ptrs != captured:
            raise RuntimeError(
                f'CUDA graph {key} was captured over other buffers: a '
                'pool or static input was reallocated without reset()')
        graph.replay()
        launch_counts.add(deltas)
        self.replays += 1
        return static_out

    def reset(self) -> None:
        """Drop every graph and the pool (the supervisor's rebuild)."""
        self._graphs.clear()
        self._capturer.reset()

    def pool_bytes(self) -> Tuple[int, int]:
        """(reserved, allocated) bytes of the graphs' pool."""
        return self._capturer.pool_bytes()

    def stats(self) -> dict:
        reserved, allocated = self.pool_bytes()
        return {'graphs': len(self._graphs),
                'captures': dict(self.captures),
                'capture_seconds': self.capture_seconds,
                'replays': self.replays,
                'pool_bytes': reserved, 'pool_allocated_bytes': allocated}


class HostStaging:
    """Host → device copies into the static input buffers. On the card
    each buffer has a pinned host twin, reused round after round; the
    copies are asynchronous, and the next fill first waits for the last
    batch of copies to have run, so a twin is never rewritten under a
    copy still queued. On the CPU a fill is a plain copy."""

    def __init__(self, device: torch.device):
        self._cuda = torch.device(device).type == 'cuda'
        self._twins: Dict[int, torch.Tensor] = {}
        self._event = torch.cuda.Event() if self._cuda else None
        self._pending = False

    def fill(self, pairs: Sequence[Tuple[torch.Tensor, np.ndarray]]) -> None:
        """Copy each numpy array into its device buffer (same shape)."""
        if not self._cuda:
            for dst, a in pairs:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        if self._pending:
            self._event.synchronize()
        for dst, a in pairs:
            twin = self._twins.get(dst.data_ptr())
            if (twin is None or twin.shape != dst.shape
                    or twin.dtype != dst.dtype):
                twin = torch.empty(dst.shape, dtype=dst.dtype,
                                   pin_memory=True)
                self._twins[dst.data_ptr()] = twin
            twin.numpy()[...] = a
            dst.copy_(twin, non_blocking=True)
        self._event.record()
        self._pending = True

    def clear(self) -> None:
        """Forget the twins (their buffers were reallocated)."""
        if self._pending:
            self._event.synchronize()
            self._pending = False
        self._twins.clear()
