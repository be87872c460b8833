"""Continuous-batching decode engine: slot-scheduled serving on one cache.

Counterpart of ``skypilot_tpu/models/engine.py``'s ``DecodeEngine``:
dense and paged modes, greedy and sampled decoding, radix prefix reuse,
per-tenant round-robin admission, clamp/reject of over-budget requests,
greedy speculative decoding and chunked prefill on the paged pool, the
crash supervisor, the serving telemetry, the cross-replica prefix fetch
and the disaggregated prefill/decode handoff. Tensor parallelism and the
block store belong to later slices.

* **One persistent cache** of ``num_slots`` lanes (dense) or one block
  pool (paged), updated in place for the life of the engine.
* **insert()** prefills one request ([1, S_bucket]; prompt lengths round
  up to bucket shapes) into a free lane; the first token samples from
  the prefill logits.
* **step()** runs ``step_chunk`` single-token decode steps across every
  slot with per-slot positions — a Python loop on the device, one host
  fetch per ``step()``. The step semantics are exactly the reference's
  ``_scan_engine_steps``: sample → EOS-force → done-fold, one budget
  unit per live step, done lanes freeze their position. Greedy engine
  output is therefore token-identical to ``decode.generate``.
* Finished slots are evicted and refilled from the admission queue.
* **Speculative decoding** (``DecodeConfig.spec_k > 0``, paged, greedy):
  each ``step()`` runs one round instead — the truncated-layer drafter
  proposes ``spec_k`` tokens per lane, one batched verify scores
  ``[token, drafts]`` against the full model, and the host accepts the
  chain-rule prefix plus one correction token, rolling a rejected tail
  back by position only (:meth:`DecodeEngine._spec_round`).
* **Chunked prefill** (``prefill_chunk > 0``, paged): an admission whose
  un-cached suffix is longer than the chunk reserves its blocks at once
  and then prefills one chunk per ``step()``, before the decode
  dispatch, so one long prompt cannot freeze every other lane. The lane
  stays done, its table row on scratch, until the last chunk delivers
  the first token (:meth:`DecodeEngine._advance_prefill`).
* **Supervision** (:meth:`DecodeEngine.run_forever`): a ``step()``
  exception fails the in-flight requests at once, rebuilds the cache and
  restarts the loop, at most ``SKYTPU_ENGINE_MAX_RESTARTS`` times in a
  rolling ``SKYTPU_ENGINE_RESTART_WINDOW_SECONDS``; past that the engine
  is failed for good and the queued requests are failed too.
* **Telemetry**, with the reference's names and call sites:
  ``skytpu_engine_*`` metrics through the package's registry
  (``observability/metrics.py``), ``engine.*`` rows through a
  :class:`~skypilot_tpu_torch.observability.journal.JournalBuffer`
  (one transaction per tick, written off the loop thread), per-request
  phase records (``observability/request_trace.RequestTelemetry``), the
  step profile, and the device-memory split (``engine.hbm``). The port
  has no jit: ``engine.compile`` marks the first dispatch of each
  distinct shape, which is also what a captured CUDA graph would key on.

**Paged mode**: a host-side :class:`BlockAllocator` (refcounts,
copy-on-write) and :class:`RadixPrefixCache` (radix tree over block-
sized token runs) decide which pool blocks a request reads; admission
reserves the request's worst case so decoding never runs out of blocks,
prefills only the suffix a cached prefix does not cover, and publishes
the prompt's full blocks. Evicted lanes repoint their table rows at
scratch block 0 so their frozen writes never land in a reused block.

**Cross-replica prefix fetch** (paged, ``prefix_peers`` or
``SKYTPU_PREFIX_PEERS``): on a local radix miss worth at least one block
the admission asks the configured peers for the prompt's blocks
(``models/prefix_transfer.py``), within ``SKYTPU_PREFIX_FETCH_BUDGET_
SECONDS``, installs what one sends verbatim (``decode.
inject_pool_blocks``), publishes it to the radix cache and re-matches,
so a fetched prefix is from then on a local hit. Any failure (timeout,
malformed or mismatched payload, pool exhausted) degrades to the local
prefill and is journaled as ``engine.prefix_fetch``. The owner side:
:meth:`DecodeEngine.export_prefix_blocks` queues a peer's request from
the HTTP thread, and ``step()`` serves it on the loop thread, which
owns the radix cache and the pool.

**Disaggregated prefill/decode handoff** (paged): a request armed with
``handoff_push`` (the model server's ``/prefill_handoff``) always admits
through the chunked path; after each chunk its newly finished full
blocks are copied to the host and pushed to the decode peer on a
background executor, at most one push in flight per slot, and once every
full block is acked the request finishes as ``'handoff'`` without a
token and its blocks go back to the pool. Any failure (a short prompt, a
failed or timed-out push, an export error) degrades the request to
decode-in-place here. The decode side: :meth:`DecodeEngine.
inject_handoff_blocks` queues a pushed chunk from the HTTP thread, and
``step()`` installs it into the pool and the radix cache, so the same
request sent there admits as a near-full prefix hit. Both directions are
counted in ``skytpu_engine_handoffs_total{result}`` and journaled as
``engine.handoff``.

The allocator, radix cache and :class:`Request` are this package's own
copies of the reference's pure-Python classes.
"""
import collections
import concurrent.futures
import functools
import heapq
import itertools
import os
import threading
import time
import traceback
import uuid
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import decode, llama, prefix_transfer
from skypilot_tpu_torch.observability import journal
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import request_trace
from skypilot_tpu_torch.observability import runtime_metrics
from skypilot_tpu_torch.ops import quant
from skypilot_tpu_torch.utils import chaos, env

IDLE_SLEEP_ENV = 'SKYTPU_ENGINE_IDLE_SLEEP_SECONDS'
# Supervisor restart budget: at most MAX_RESTARTS crash restarts within
# a rolling RESTART_WINDOW; one more crash inside the window fails the
# engine for good.
MAX_RESTARTS_ENV = 'SKYTPU_ENGINE_MAX_RESTARTS'
DEFAULT_MAX_RESTARTS = 3
RESTART_WINDOW_ENV = 'SKYTPU_ENGINE_RESTART_WINDOW_SECONDS'
DEFAULT_RESTART_WINDOW_SECONDS = 300.0
# Chunked prefill: paged admissions whose un-cached suffix exceeds this
# many tokens prefill one chunk per step (0 disables).
PREFILL_CHUNK_ENV = 'SKYTPU_PREFILL_CHUNK'
# The pool's block 0 is engine-owned scratch: freed slots' table rows
# point at it so frozen lanes write harmlessly, and bucket-padding
# prefill writes spill into it. The allocator never hands it out.
SCRATCH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """An admission's block reservation cannot be met (even after
    prefix-cache eviction); the request stays queued."""


class BlockAllocator:
    """Refcounted free-list allocator over the paged pool's blocks.

    Blocks are ints in [reserved, num_blocks). A block's refcount is its
    number of owners: each slot whose table references it, plus the
    radix cache when a tree node holds it. Host-side only."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(f'num_blocks must be > {reserved}, got '
                             f'{num_blocks}')
        self.num_blocks = num_blocks
        self._reserved = reserved
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1,
                                           -1))
        self._ref = np.zeros((num_blocks,), np.int32)

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        return (self.num_blocks - self._reserved) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); raises PoolExhausted."""
        if n > len(self._free):
            raise PoolExhausted(f'need {n} blocks, {len(self._free)} free')
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        return out

    def incref(self, blocks) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f'incref of free block {b}')
            self._ref[b] += 1

    def decref(self, blocks) -> List[int]:
        """Drop one ref per block; returns the blocks actually freed."""
        freed = []
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f'decref of free block {b}')
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def cow(self, block: int) -> Tuple[int, bool]:
        """Copy-on-write for a caller holding one ref and about to write
        ``block``: sole owner → write in place; shared → a fresh clone
        target the caller device-copies into. Returns (writable block,
        needs_copy)."""
        if self._ref[block] == 1:
            return block, False
        return self.alloc(1)[0], True


class _RadixNode:
    """One edge of the prefix tree: a run of whole blocks. ``keys[i]``
    is the tuple of block_k token ids held by pool block ``blocks[i]``;
    ``lock`` counts in-flight requests that matched through it."""

    __slots__ = ('keys', 'blocks', 'children', 'parent', 'lock', 'last')

    def __init__(self, keys, blocks, parent):
        self.keys: List[tuple] = keys
        self.blocks: List[int] = blocks
        self.children: dict = {}
        self.parent = parent
        self.lock = 0
        self.last = 0


class RadixPrefixCache:
    """Radix tree mapping prompt-token prefixes → pool blocks, at block
    granularity: partial blocks are never shared, so shared blocks are
    immutable and copy-on-write is only needed at the boundary block of
    a full-prompt hit. The tree owns one allocator ref per held block;
    ``evict`` LRU-walks unlocked leaves under pool pressure."""

    def __init__(self, block_k: int, allocator: BlockAllocator):
        self.block_k = block_k
        self._alloc = allocator
        self._root = _RadixNode([], [], None)
        self._clock = 0
        self._n_blocks = 0
        self._n_nodes = 0

    def _block_keys(self, tokens) -> List[tuple]:
        bk = self.block_k
        return [tuple(tokens[i * bk:(i + 1) * bk])
                for i in range(len(tokens) // bk)]

    def held_blocks(self) -> int:
        return self._n_blocks

    def node_count(self) -> int:
        return self._n_nodes

    def _touch(self, node: _RadixNode) -> None:
        self._clock += 1
        node.last = self._clock

    def match(self, tokens) -> Tuple[List[int], List[_RadixNode]]:
        """Longest cached prefix of ``tokens`` in whole blocks: (blocks,
        path). The caller gets one allocator ref per matched block and a
        lock on every path node, returned through decref + release."""
        keys = self._block_keys(tokens)
        blocks: List[int] = []
        path: List[_RadixNode] = []
        node = self._root
        i = 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            n = 0
            while (n < len(child.keys) and i + n < len(keys) and
                   child.keys[n] == keys[i + n]):
                n += 1
            if n == 0:
                break
            blocks.extend(child.blocks[:n])
            path.append(child)
            self._touch(child)
            i += n
            if n < len(child.keys):
                break
            node = child
        if blocks:
            self._alloc.incref(blocks)
            for p in path:
                p.lock += 1
        return blocks, path

    def release(self, path) -> None:
        for p in path:
            if p.lock <= 0:
                raise RuntimeError('radix release of an unlocked node')
            p.lock -= 1

    def insert(self, tokens, blocks) -> int:
        """Record that ``blocks[i]`` holds block i of ``tokens`` (a whole
        number of blocks). Cached prefixes dedupe; only the divergent
        suffix is adopted. Returns the number of blocks adopted."""
        keys = self._block_keys(tokens)
        if len(keys) != len(blocks):
            raise ValueError(f'{len(keys)} token blocks vs {len(blocks)} '
                             'pool blocks')
        node = self._root
        i = 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                new = _RadixNode(keys[i:], list(blocks[i:]), node)
                node.children[keys[i]] = new
                self._touch(new)
                self._n_nodes += 1
                self._alloc.incref(new.blocks)
                self._n_blocks += len(new.blocks)
                return len(new.blocks)
            n = 0
            while (n < len(child.keys) and i + n < len(keys) and
                   child.keys[n] == keys[i + n]):
                n += 1
            self._touch(child)
            if n < len(child.keys):
                if i + n == len(keys):
                    return 0        # new prompt is a prefix of the edge
                self._split(child, n)
            i += n
            node = child
        return 0

    def _split(self, node: _RadixNode, at: int) -> None:
        """Split an edge at block ``at``: the node keeps the prefix (and
        its locks), a new child takes the tail and the children."""
        tail = _RadixNode(node.keys[at:], node.blocks[at:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last = node.last
        node.keys = node.keys[:at]
        node.blocks = node.blocks[:at]
        node.children = {tail.keys[0]: tail}
        self._n_nodes += 1

    def evict(self, need_blocks: int) -> int:
        """LRU-evict unlocked leaves until ``need_blocks`` blocks came
        free (or nothing is evictable); skips leaves whose blocks are all
        pinned by slots (evicting them frees nothing). Returns blocks
        freed."""
        freed = 0
        heap = [(n.last, id(n), n) for n in self._iter_nodes()
                if not n.children and n is not self._root]
        heapq.heapify(heap)
        while freed < need_blocks and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.lock != 0 or victim.children:
                continue
            if all(self._alloc.refcount(b) > 1 for b in victim.blocks):
                continue
            freed += len(self._alloc.decref(victim.blocks))
            self._n_blocks -= len(victim.blocks)
            self._n_nodes -= 1
            parent = victim.parent
            del parent.children[victim.keys[0]]
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last, id(parent), parent))
        return freed

    def _iter_nodes(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())


class Request:
    """One generation request tracked through the engine.

    ``on_token(token, done)`` fires from the engine thread per token;
    ``on_finish()`` fires once at the terminal state, rejections
    included. ``tokens`` accumulates the generation; ``wait()`` blocks
    until the request finishes.

    ``trace_id`` (the server's ``X-Request-Id``) stamps this request's
    journal rows, and ``span_id`` (the server's ``server.request`` span)
    nests them under the HTTP span; None leaves the ambient trace.
    ``prefix_hint`` (the load balancer's prefix-owner header) moves a
    configured peer of the same URL to the front of the prefix fetch's
    try order; it never adds one.
    ``handoff_push(tokens_prefix, payload) -> bool`` (True: acked), when
    set, streams the request's KV blocks to a decode peer as its prefill
    chunks finish, and the request then finishes as ``'handoff'``
    without decoding; any push failure degrades it to decode-in-place.
    ``handoff_peer`` (the decode peer's URL) keys the peer's backoff.
    ``enqueue_ts``/``first_token_ts``/``finish_ts`` are
    ``time.perf_counter()`` stamps the telemetry plane reads."""
    _ids = itertools.count()

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 on_token: Optional[Callable[[int, bool], None]] = None,
                 request_id: Optional[str] = None,
                 tenant: str = 'default',
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 prefix_hint: Optional[str] = None):
        if max_new_tokens < 1:
            raise ValueError(f'max_new_tokens must be >= 1, got '
                             f'{max_new_tokens}')
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError('empty prompt')
        self.max_new_tokens = int(max_new_tokens)
        self.on_token = on_token
        self.on_finish: Optional[Callable[[], None]] = None
        self.tenant = str(tenant)
        self.id = (request_id if request_id is not None
                   else f'r{next(self._ids)}')
        self.trace_id = trace_id
        self.span_id = span_id
        self.prefix_hint = prefix_hint
        self.handoff_push: Optional[Callable[..., bool]] = None
        self.handoff_peer: Optional[str] = None
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.enqueue_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _deliver(self, token: int, done: bool) -> None:
        self.tokens.append(token)
        if self.first_token_ts is None:
            self.first_token_ts = time.perf_counter()
        if self.on_token is not None:
            self.on_token(token, done)

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.finish_ts = time.perf_counter()
        self._done.set()
        if self.on_finish is not None:
            self.on_finish()


def _spec_step(params, token: torch.Tensor, pos: torch.Tensor,
               draft_tables: torch.Tensor, block_tables: torch.Tensor,
               cache, cfg: llama.LlamaConfig, dcfg: decode.DecodeConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One speculative round over every slot: draft ``spec_k`` tokens per
    lane (pool read-only, through ``draft_tables``, the tables narrowed
    to the live blocks), then one verify of ``[token, drafts]`` through
    the full ``block_tables`` (its writes land at pos..pos+spec_k, which
    may lie past the live prefix). Returns (drafts [B, spec_k], the
    verify argmax [B, spec_k + 1]). Counterpart of the reference's
    ``_engine_spec_step_impl``."""
    drafts = decode.spec_draft_tokens(params, token, pos, draft_tables,
                                      cfg, dcfg, cache)
    seq = torch.cat([token[:, None], drafts], dim=1)
    logits = decode.paged_verify_step(params, seq, pos, block_tables, cfg,
                                      dcfg, cache)
    return drafts, logits.argmax(dim=-1)


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples (an
    int8 weight counts its values and its scales)."""
    if isinstance(tree, (torch.Tensor, quant.QuantizedTensor)):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(_tree_nbytes(t) for t in tree)


def _default_buckets(max_len: int) -> Tuple[int, ...]:
    """Prompt-length buckets: powers of two from 8 up to max_len."""
    buckets = []
    b = 8
    while b < max_len:
        buckets.append(min(b, max_len))
        b *= 2
    if not buckets or buckets[-1] < max_len:
        buckets.append(max_len)
    return tuple(buckets)


class DecodeEngine:
    """Slot-based continuous-batching engine over ``models/decode``.

    ``submit()`` is thread-safe (the server's handlers call it);
    ``insert()``/``step()``/``run_forever()`` run on ONE engine thread,
    which owns the cache. The engine runs on the device its params live
    on. ``prefill_chunk`` defaults to ``SKYTPU_PREFILL_CHUNK`` and is
    forced to 0 when not paged. ``journal_db`` pins the engine's journal
    rows to one file (None: the host journal, ``journal.db_path()``).

    ``prefix_peers`` (default ``SKYTPU_PREFIX_PEERS``, comma-separated;
    kept only when paged) are the replicas a radix miss fetches from,
    within ``prefix_fetch_budget`` seconds (default
    ``SKYTPU_PREFIX_FETCH_BUDGET_SECONDS`` or 0.5).
    ``prefix_fetch_fn(peer_url, tokens, from_tokens, budget)`` is the
    transport (default: ``prefix_transfer.http_fetch`` carrying this
    engine's ``instance_id``); tests hand in direct engine-to-engine
    calls."""

    def __init__(self, params, cfg: llama.LlamaConfig,
                 dcfg: decode.DecodeConfig, num_slots: int,
                 step_chunk: int = 1,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 name: str = 'engine', paged: bool = False,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_peers: Optional[Sequence[str]] = None,
                 prefix_fetch_budget: Optional[float] = None,
                 prefix_fetch_fn: Optional[Callable] = None,
                 journal_db: Optional[str] = None):
        if num_slots < 1:
            raise ValueError(f'num_slots must be >= 1, got {num_slots}')
        if step_chunk < 1:
            raise ValueError(f'step_chunk must be >= 1, got {step_chunk}')
        if dcfg.spec_k:
            # Verify is a multi-token decode over the block tables, and
            # the round commits the full model's argmax: paged and greedy
            # by construction.
            if not paged:
                raise ValueError('speculative decoding (spec_k > 0) '
                                 'requires paged=True')
            if dcfg.temperature != 0.0:
                raise ValueError(
                    'speculative decoding is greedy-only; got '
                    f'temperature={dcfg.temperature}')
            if not 1 <= dcfg.spec_drafter_layers <= cfg.n_layers:
                raise ValueError(
                    f'spec_drafter_layers must be in [1, '
                    f'{cfg.n_layers}], got {dcfg.spec_drafter_layers}')
        self.params = params
        self.device = params['tok_embedding'].device
        self.cfg = cfg
        self.dcfg = dcfg
        self.num_slots = num_slots
        self.step_chunk = step_chunk
        self.name = name
        self.paged = paged
        self._block_k = dcfg.kernel_block_k
        self._buckets = (tuple(sorted(int(b) for b in prefill_buckets))
                         if prefill_buckets
                         else _default_buckets(dcfg.max_len))
        if self._buckets[-1] > dcfg.max_len:
            raise ValueError(f'prefill buckets {self._buckets} exceed '
                             f'max_len {dcfg.max_len}')
        if paged:
            bk = self._block_k
            if dcfg.max_len % bk:
                raise ValueError(
                    f'paged mode needs max_len ({dcfg.max_len}) '
                    f'divisible by block_k ({bk})')
            # Prefill writes whole blocks: snap buckets to block
            # multiples.
            self._buckets = tuple(sorted({
                min(-(-b // bk) * bk, dcfg.max_len)
                for b in self._buckets}))
            self._max_blocks = dcfg.max_len // bk
            # Default pool: the dense cache's token capacity + scratch.
            self.num_blocks = (num_blocks if num_blocks is not None
                               else num_slots * self._max_blocks + 1)
        else:
            self.num_blocks = 0
        # A paged-admission policy: the chunk calls name their block rows
        # explicitly, which the dense cache has no use for.
        if prefill_chunk is None:
            prefill_chunk = env.env_int(PREFILL_CHUNK_ENV, 0)
        self.prefill_chunk = max(0, int(prefill_chunk)) if paged else 0
        self._prefill_chunks = 0
        self._chunked_admissions = 0
        self._prompt_tokens_total = 0
        self._prompt_tokens_saved = 0
        self._prefix_evictions = 0
        # Cross-replica prefix tier (paged only): the peers a local radix
        # miss consults, within the fetch budget, so a slow peer degrades
        # the admission to a local prefill and never stalls it.
        if prefix_peers is None:
            raw = os.environ.get(prefix_transfer.PREFIX_PEERS_ENV, '')
            prefix_peers = [u.strip() for u in raw.split(',')
                            if u.strip()]
        self.prefix_peers: List[str] = list(prefix_peers) if paged else []
        self.prefix_fetch_budget = (
            prefix_fetch_budget if prefix_fetch_budget is not None
            else env.env_float(prefix_transfer.FETCH_BUDGET_ENV,
                               prefix_transfer.DEFAULT_FETCH_BUDGET_SECONDS))
        # Fetch only when at least this many block-aligned tokens stand
        # to be gained (default one block, the least a peer can ship).
        self._prefix_fetch_min_tokens = env.env_int(
            prefix_transfer.FETCH_MIN_TOKENS_ENV, self._block_k)
        # This engine's identity: the default transport sends it with
        # every fetch, and /prefix_blocks answers {'self': true} when it
        # reaches the engine that minted it, the one sure self-detection
        # under a fleet-shared peers list.
        self.instance_id = uuid.uuid4().hex
        self._prefix_fetch_fn = (
            prefix_fetch_fn if prefix_fetch_fn is not None
            else functools.partial(prefix_transfer.http_fetch,
                                   instance=self.instance_id))
        # A peer whose fetch failed sits out this many seconds; a
        # successful fetch clears its backoff.
        self._prefix_fetch_backoff = env.env_float(
            prefix_transfer.FETCH_BACKOFF_ENV,
            prefix_transfer.DEFAULT_FETCH_BACKOFF_SECONDS)
        self._peer_backoff_until: dict = {}
        # URLs that address this replica (the model server registers
        # its own): a self-fetch would stall the loop for a whole budget,
        # since the loop doing the fetch is the one that serves exports.
        self._prefix_self_urls: set = set()
        self._prefix_fetch_hits = 0
        self._prefix_fetch_misses = 0
        self._prefix_fetch_tokens = 0
        # Disaggregated handoff, both directions: pushes made as the
        # prefill side, injections served as the decode side.
        self._handoffs_completed = 0
        self._handoffs_degraded = 0
        self._handoff_tokens_pushed = 0
        self._handoff_injections = 0
        self._handoff_tokens_injected = 0
        # The pushes' executor, made at the first handoff and shut down
        # when the loop ends or the supervisor restarts.
        self._handoff_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        # Peers' /prefix_blocks exports and /handoff_blocks injections
        # queue here from any thread and are served by the loop at the top
        # of each step (the radix cache and the pool are loop-confined).
        self._export_lock = threading.Lock()
        self._export_jobs: List[dict] = []
        # engine.compile dedupe: dispatch shapes already noted. Restarts
        # keep it, as the reference's process-global jit cache does.
        self._traced_shapes: set = set()
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self._generator = generator
        self._init_runtime_state()
        self._queue_lock = threading.Lock()
        self._queues: 'collections.OrderedDict[str, collections.deque]' \
            = collections.OrderedDict()
        self._rr_offset = 0
        self._decode_steps = 0
        self._decode_emitted = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._admitted = 0
        self._evicted = 0
        self._rejected = 0
        # Journal rows batch into one sqlite transaction per tick, written
        # off the loop thread (stats() flushes from the HTTP thread while
        # the loop appends).
        self.journal_db = journal_db
        self._jbuf = journal.JournalBuffer(db_path=journal_db,
                                           entity=f'engine:{name}')
        # Per-request phase records assembled at the admit/evict/reject
        # choke points, and the per-step profile behind /debug/engine.
        self.telemetry = request_trace.RequestTelemetry(name=name)
        self.profiler = request_trace.EngineStepProfiler(name=name)
        self._restarts = 0
        self._crash_times: List[float] = []
        # True while _admit runs: a request popped from its queue and not
        # yet slotted is neither queued nor active.
        self._admitting = False
        self.failed = False
        self.fail_reason: Optional[str] = None
        self._m = metrics_lib
        self._m.gauge('skytpu_engine_num_slots',
                      'Configured KV-cache lanes.').set(num_slots)
        self._publish_slot_gauges()
        # One device and no mesh: the reference's unsharded engine.
        self._m.gauge(
            'skytpu_engine_tp_degree',
            'Tensor-parallel degree of the serving mesh (1 = '
            'unsharded).').set(1)
        self._m.gauge(
            'skytpu_engine_mesh_devices',
            'Devices in the engine serving mesh.').set(1)
        cuda = self.device.type == 'cuda'
        # engine.mesh and engine.hbm: journaled once at engine start (the
        # supervisor's rebuild makes an identically sized cache).
        self._journal_raw(journal.EventKind.ENGINE_MESH, {
            'tp': 1,
            'mesh_shape': {'model': 1},
            'devices': 1,
            'device_kinds': [torch.cuda.get_device_name(self.device)
                             if cuda else 'cpu'],
            'platform': 'gpu' if cuda else 'cpu',
            'process_count': 1,
            'paged': self.paged,
        })
        hbm = self._hbm_accounting()
        hbm_g = self._m.gauge(
            'skytpu_engine_hbm_bytes',
            'Per-device HBM bytes by consumer: sharded weights, the '
            'paged KV pool (or dense cache), and measured workspace '
            'residual.', labels=('kind',))
        for kind, nbytes in hbm['per_device_bytes'].items():
            hbm_g.set(nbytes, labels=(kind,))
        self._journal_raw(journal.EventKind.ENGINE_HBM, {'tp': 1, **hbm})
        self.flush_journal()

    def _hbm_accounting(self) -> dict:
        """Device byte split of this engine's footprint. Weights and the
        pool (or dense cache) are exact byte sums of their tensors;
        workspace is the rest of ``torch.cuda.memory_allocated`` on the
        card (``workspace_measured: true``), and 0 on the CPU, which has
        no device memory to meter (``workspace_measured: false``)."""
        weights = _tree_nbytes(self.params)
        pool = _tree_nbytes(self._cache)
        pool_kind = 'paged_pool' if self.paged else 'kv_cache'
        workspace = 0
        measured = self.device.type == 'cuda'
        if measured:
            workspace = max(0, torch.cuda.memory_allocated(self.device)
                            - weights - pool)
        return {
            'per_device_bytes': {'weights': weights,
                                 pool_kind: pool,
                                 'workspace': workspace},
            'workspace_measured': measured,
            'pool_kind': pool_kind,
        }

    def _init_runtime_state(self) -> None:
        """(Re)build what a crashed step may have left inconsistent: the
        device cache/pool, the allocator + radix cache, block tables and
        the per-slot host mirrors. Called at construction and by the
        supervisor's restart; the queues and cumulative stats stay, so
        queued requests re-prefill against the fresh cache."""
        num_slots = self.num_slots
        # Drop the old cache before allocating the new one: both at once
        # would not fit beside the weights at full width.
        self._cache = None
        self._block_table_dev = None
        if self.paged:
            self._cache = decode.init_block_pool(
                self.cfg, self.num_blocks, self._block_k,
                self.dcfg.kv_cache_dtype, self.device)
            self._allocator = BlockAllocator(self.num_blocks)
            self._radix = RadixPrefixCache(self._block_k, self._allocator)
            # Rows of free slots point at SCRATCH_BLOCK; the device copy
            # is re-uploaded only after admission/eviction changes it.
            self._block_table_np = np.zeros(
                (num_slots, self._max_blocks), np.int32)
            self._block_table_dev: Optional[torch.Tensor] = None
            self._slot_refs: List[List[int]] = [[] for _ in
                                                range(num_slots)]
            self._slot_nodes: List[list] = [[] for _ in range(num_slots)]
        else:
            self._cache = decode.init_kv_cache(self.cfg, num_slots,
                                               self.dcfg.max_len,
                                               self.dcfg.kv_cache_dtype,
                                               self.device)
        # Chunked-prefill resume state: slot -> {'req', 'table', 'p',
        # 'm', 'next', 'chunk'} while an admission is mid-prefill, plus
        # 'hand', 'pushed', 'hand_failed' (and 'hand_fut' while a push is
        # in flight) for a handoff.
        self._prefill_state: List[Optional[dict]] = [None] * num_slots
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._token = np.zeros((num_slots,), np.int64)
        self._pos = np.zeros((num_slots,), np.int64)
        self._done = np.ones((num_slots,), bool)
        self._remaining = np.zeros((num_slots,), np.int64)

    # ------------------------------------------------------------ intake

    def submit(self, request: Request) -> Request:
        """Enqueue a request for admission (thread-safe). On a permanently
        failed engine the request finishes at once as an error: nothing
        would ever admit it."""
        request.enqueue_ts = time.perf_counter()
        self.telemetry.on_enqueue(request)
        with self._queue_lock:
            queued = not self.failed
            if queued:
                q = self._queues.get(request.tenant)
                if q is None:
                    q = self._queues[request.tenant] = collections.deque()
                q.append(request)
            depth = sum(len(d) for d in self._queues.values())
        if not queued:
            self._fail_request(request, 'engine failed permanently')
        self._publish_queue_depth(depth)
        return request

    def queue_depth(self) -> int:
        with self._queue_lock:
            return sum(len(d) for d in self._queues.values())

    def _pop_next(self) -> Optional[Request]:
        """Round-robin pop across tenant queues."""
        with self._queue_lock:
            tenants = list(self._queues)
            for i in range(len(tenants)):
                tenant = tenants[(self._rr_offset + i) % len(tenants)]
                q = self._queues[tenant]
                if q:
                    # The next round starts at the FOLLOWING tenant.
                    self._rr_offset = \
                        (self._rr_offset + i + 1) % len(tenants)
                    req = q.popleft()
                    if not q:
                        del self._queues[tenant]
                    return req
            return None

    def _requeue_front(self, request: Request) -> None:
        """Put an un-admittable request back at the head of its tenant
        queue and park the round-robin pointer on that tenant, so it is
        retried first and smaller requests cannot starve it."""
        with self._queue_lock:
            q = self._queues.get(request.tenant)
            if q is None:
                q = self._queues[request.tenant] = collections.deque()
                self._queues.move_to_end(request.tenant, last=False)
            q.appendleft(request)
            self._rr_offset = list(self._queues).index(request.tenant)
            depth = sum(len(d) for d in self._queues.values())
        # Restore the gauge _admit lowered for the pop: a starved head-of-
        # line request must not read as depth 0.
        self._publish_queue_depth(depth)

    def _publish_queue_depth(self, depth: Optional[int] = None) -> int:
        """The one writer of the queue-depth gauge (submit, requeue,
        admission and the step profiler publish through here)."""
        if depth is None:
            depth = self.queue_depth()
        self._m.gauge('skytpu_engine_queue_depth',
                      'Requests waiting for a free slot.').set(depth)
        return depth

    def free_slots(self) -> int:
        return sum(1 for r in self._slots if r is None)

    def active_slots(self) -> int:
        return self.num_slots - self.free_slots()

    def idle(self) -> bool:
        """Nothing queued, admitting or in a slot (the server's drain
        waits for this). Read in this order: ``_admit`` raises its flag
        before it pops and lowers it once the request is slotted."""
        return (self.queue_depth() == 0 and not self._admitting and
                self.active_slots() == 0)

    # --------------------------------------------------------- admission

    def insert(self, request: Request) -> int:
        """Prefill one request into a free slot; the first token samples
        from the prefill logits. Returns the slot. Raises RuntimeError
        when no slot is free, ValueError when the request exceeds
        max_len, PoolExhausted when the paged pool cannot cover it
        (nothing mutated; requeue). A chunked admission returns with the
        blocks reserved and no token yet: the lane stays done, its table
        row on scratch, until :meth:`_finish_prefill`."""
        slot = next((i for i, r in enumerate(self._slots) if r is None),
                    None)
        if slot is None:
            raise RuntimeError('no free slot')
        p = len(request.prompt)
        if p + request.max_new_tokens > self.dcfg.max_len:
            raise ValueError(
                f'prompt ({p}) + max_new_tokens '
                f'({request.max_new_tokens}) exceeds max_len '
                f'{self.dcfg.max_len}')
        if request.enqueue_ts is None:
            request.enqueue_ts = time.perf_counter()
        admit_ts = time.perf_counter()
        if self.paged:
            first, shared_tokens = self._prefill_paged(slot, request)
            if first is None:
                self._chunked_admissions += 1
                self._count_admitted()
                self.telemetry.on_admit(
                    request, slot, admit_ts=admit_ts,
                    prefix_hit_tokens=shared_tokens,
                    blocks_reserved=len(self._slot_refs[slot]))
                self._journal(journal.EventKind.ENGINE_ADMIT, request,
                              slot, prompt_len=p,
                              prefix_hit_tokens=shared_tokens,
                              max_new_tokens=request.max_new_tokens,
                              chunked=True,
                              prefill_chunk=self.prefill_chunk)
                self._slots[slot] = request
                self._done[slot] = True
                self._remaining[slot] = 0
                self._publish_slot_gauges()
                return slot
        else:
            shared_tokens = 0
            bucket = self._bucket_for(p)
            self._note_compile('prefill', bucket=bucket)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :p] = request.prompt
            last = decode.prefill_into_slot(
                self.params, torch.as_tensor(padded, device=self.device),
                p, slot, self.cfg, self._cache)
            first = self._sample_first(last)
        self._count_admitted()
        self.telemetry.on_admit(
            request, slot, admit_ts=admit_ts,
            prefix_hit_tokens=shared_tokens,
            blocks_reserved=(len(self._slot_refs[slot]) if self.paged
                             else 0))
        self._journal(journal.EventKind.ENGINE_ADMIT, request, slot,
                      prompt_len=p, prefix_hit_tokens=shared_tokens,
                      max_new_tokens=request.max_new_tokens)
        self._deliver_first(slot, request, first)
        return slot

    def _count_admitted(self) -> None:
        self._admitted += 1
        self._m.counter('skytpu_engine_admitted_total',
                        'Requests admitted into a slot.').inc()

    def _deliver_first(self, slot: int, request: Request,
                       first: int) -> None:
        """First-token delivery and decode-lane init, shared by direct
        admission and the chunked-prefill finish: the TTFT observation
        (counted before the token reaches the client); a one-token or
        immediate-EOS request never occupies a decode lane."""
        self._m.histogram(
            'skytpu_engine_ttft_seconds',
            'Time from enqueue to first token (includes queueing).',
            buckets=runtime_metrics.TTFT_BUCKETS).observe(
                time.perf_counter() - request.enqueue_ts)
        self._count_tokens(1)
        hit_eos = (self.dcfg.eos_id is not None and
                   first == self.dcfg.eos_id)
        first_done = hit_eos or request.max_new_tokens == 1
        if first_done:
            # done=True must never be observable before the reason.
            request.finish_reason = 'eos' if hit_eos else 'length'
        request._deliver(first, done=first_done)  # pylint: disable=protected-access
        self._slots[slot] = request
        if first_done:
            self._evict(slot, 'eos' if hit_eos else 'length')
            return
        self._token[slot] = first
        self._pos[slot] = len(request.prompt)
        self._done[slot] = False
        self._remaining[slot] = request.max_new_tokens - 1
        self._publish_slot_gauges()

    def _count_tokens(self, n: int) -> None:
        self._m.counter('skytpu_engine_tokens_total',
                        'Tokens generated by the engine.').inc(n)

    def _prefill_paged(self, slot: int, request: Request
                       ) -> Tuple[Optional[int], int]:
        """Paged admission: radix-match the prompt, reserve the worst
        case, copy-on-write the boundary block of a full-prompt hit,
        prefill only the un-cached suffix, publish the prompt's full
        blocks. Returns (first token, shared prefix tokens), or (None,
        shared) when the suffix exceeds ``prefill_chunk``: the
        reservation is made, the resume state parked, and
        :meth:`_advance_prefill` runs one chunk per step. Raises
        PoolExhausted with no state mutated when the reservation cannot
        be met. A handoff request always takes the chunked path, in one
        chunk of the whole suffix when chunking is off, because the
        per-chunk hook is where its blocks stream to the decode peer."""
        bk = self._block_k
        p = len(request.prompt)
        handoff = request.handoff_push is not None
        if handoff and p < bk:
            # Nothing block-aligned to hand off: decode in place (the
            # model server filters these only by trust, so a short prompt
            # must degrade here, not wedge).
            request.handoff_push = None
            handoff = False
            self._handoff_degrade(request, 'short_prompt', prompt_len=p)
        blocks, path = self._radix.match(request.prompt)
        m_full = len(blocks) * bk
        if self._should_prefix_fetch(p, m_full):
            if self._prefix_fetch_into_cache(request, blocks, m_full):
                # The fetched blocks now live in the pool and the radix
                # cache: drop the stale match and match again, which
                # takes the extended prefix with its refs and locks, so
                # a remote hit is from here on a local one.
                self._allocator.decref(blocks)
                self._radix.release(path)
                blocks, path = self._radix.match(request.prompt)
                m_full = len(blocks) * bk
        # Keep >= 1 suffix token: the first generated token samples from
        # the last prompt position's logits, which only a forward pass
        # produces.
        m = min(m_full, p - 1)
        first_owned = m // bk
        n_total = -(-(p + request.max_new_tokens) // bk)
        need = n_total - first_owned
        short = need - self._allocator.available()
        if short > 0:
            self._radix_evict(short)
        cow_dst = cow_src = None
        try:
            if m < m_full:
                # Full-prompt hit snapped back mid-block: the suffix
                # rewrite lands in a SHARED block (the tree and our match
                # ref pin it), so copy-on-write always clones here.
                cow_src = blocks[first_owned]
                cow_dst, needs_copy = self._allocator.cow(cow_src)
                if not needs_copy:
                    raise RuntimeError(f'copy-on-write of pinned block '
                                       f'{cow_src} granted in place')
                owned = [cow_dst] + self._allocator.alloc(need - 1)
            else:
                needs_copy = False
                owned = self._allocator.alloc(need)
        except PoolExhausted:
            if cow_dst is not None:
                self._allocator.decref([cow_dst])
            self._allocator.decref(blocks)
            self._radix.release(path)
            raise
        table = blocks[:first_owned] + owned
        try:
            if needs_copy:
                decode.copy_block(self._cache, cow_src, cow_dst)
            if handoff or (self.prefill_chunk and
                           p - m > self.prefill_chunk):
                # Chunked admission: the reservation and the boundary
                # copy happen now; the suffix runs one chunk per step.
                # The slot's table row stays on scratch until the last
                # chunk (the chunk calls name their rows explicitly), so
                # the frozen lane's decode writes cannot land in a half-
                # prefilled block, and the radix publish waits until the
                # blocks hold real K/V.
                self._slot_refs[slot] = blocks + owned
                self._slot_nodes[slot] = path
                self._prefill_state[slot] = {
                    'req': request, 'table': table, 'p': p, 'm': m,
                    'next': m, 'chunk': self.prefill_chunk or (p - m),
                    'hand': handoff, 'pushed': 0, 'hand_failed': False}
                self._publish_block_gauges()
                return None, m
            last = self._prefill_range(request.prompt, m, p, table)
            self._publish_prompt(request.prompt, m, table)
        except Exception:
            # Any failure past allocation returns the reservation (the
            # tree keeps the refs it took in insert()).
            self._allocator.decref(blocks + owned)
            self._radix.release(path)
            raise
        self._slot_refs[slot] = blocks + owned
        self._slot_nodes[slot] = path
        self._block_table_np[slot, :] = SCRATCH_BLOCK
        self._block_table_np[slot, :n_total] = table
        self._block_table_dev = None
        self._publish_block_gauges()
        return self._sample_first(last), m

    def _radix_evict(self, need: int) -> int:
        """The one gateway to radix LRU eviction: counts freed blocks."""
        freed = self._radix.evict(need)
        if freed:
            self._prefix_evictions += freed
            self._m.counter(
                'skytpu_engine_prefix_evictions_total',
                'Prefix-cache blocks LRU-evicted under pool '
                'pressure.').inc(freed)
        return freed

    # ------------------------------------------ cross-replica prefix tier

    def _should_prefix_fetch(self, p: int, m_full: int) -> bool:
        """Consult peers only when a fetch could help: peers are
        configured (a load balancer's hint alone introduces none) and
        the local miss leaves at least the minimum block-aligned gain."""
        if not self.paged or not self.prefix_peers:
            return False
        aligned = (p // self._block_k) * self._block_k
        return aligned - m_full >= max(self._prefix_fetch_min_tokens,
                                       self._block_k)

    def register_self_url(self, url: str) -> None:
        """Model-server hook: URLs that address this replica are never
        fetched from."""
        self._prefix_self_urls.add(url.rstrip('/'))

    def _prefix_fetch_peers(self, request: Request) -> List[str]:
        """The configured peers minus self and those in backoff. The
        load balancer's owner hint only moves a matching configured peer
        to the front: it rides a header any client can set, and fetching
        from an unvetted URL would publish its KV blocks to every tenant.
        The peer list is the trust set."""
        now = time.perf_counter()
        hint = (request.prefix_hint or '').rstrip('/')
        peers = []
        for u in sorted(self.prefix_peers,
                        key=lambda u: 0 if u.rstrip('/') == hint else 1):
            if (u and u not in peers
                    and u.rstrip('/') not in self._prefix_self_urls
                    and self._peer_backoff_until.get(u, 0.0) <= now):
                peers.append(u)
        return peers

    def _note_peer_failure(self, peer: str) -> None:
        self._peer_backoff_until[peer] = (time.perf_counter() +
                                          self._prefix_fetch_backoff)

    def peer_in_backoff(self, peer: str) -> bool:
        """Is ``peer`` inside its failure-backoff window?"""
        return self._peer_backoff_until.get(peer,
                                            0.0) > time.perf_counter()

    def _count_prefix_fetch(self, result: str) -> None:
        self._m.counter(
            'skytpu_engine_prefix_fetches_total',
            'Cross-replica prefix-block fetch attempts by outcome.',
            labels=('result',)).inc(labels=(result,))

    def _prefix_fetch_into_cache(self, request: Request,
                                 local_blocks: List[int],
                                 m_full: int) -> bool:
        """Pull the prompt's missing prefix blocks from a peer into the
        pool and the radix cache; True when the cache now holds a longer
        prefix (the caller matches again). Bounded by the fetch budget.
        Every failure (timeout, malformed payload, dtype or shape
        mismatch, pool exhausted) degrades to the local prefill, with the
        outcome journaled as ``engine.prefix_fetch``."""
        bk = self._block_k
        aligned = (len(request.prompt) // bk) * bk
        t0 = time.perf_counter()
        deadline = t0 + self.prefix_fetch_budget
        outcome = 'miss'
        peers_tried = self._prefix_fetch_peers(request)
        for peer in peers_tried:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                outcome = 'budget_exhausted'
                break
            try:
                payload = self._prefix_fetch_fn(
                    peer, request.prompt[:aligned], m_full, remaining)
            except Exception as e:  # pylint: disable=broad-except
                # A misbehaving peer or transport never crashes admission.
                self._note_peer_failure(peer)
                outcome = 'error'
                self._journal(journal.EventKind.ENGINE_PREFIX_FETCH,
                              request, -1, outcome='error', peer=peer,
                              error=f'{type(e).__name__}: {e}')
                continue
            if payload is None:
                # A transport failure backs the peer off; an honest empty
                # match is a payload and lands in the 'empty' branch.
                self._note_peer_failure(peer)
                continue
            if payload.get('self'):
                # The peer answered "I am you": one of our own addresses.
                self.register_self_url(peer)
                continue
            try:
                gained = self._install_remote_blocks(
                    request.prompt, payload, local_blocks, m_full)
            except Exception as e:  # pylint: disable=broad-except
                # A failure past validation (device memory): degrade,
                # never crash the step (the allocator refs came back).
                self._note_peer_failure(peer)
                outcome = 'error'
                self._journal(journal.EventKind.ENGINE_PREFIX_FETCH,
                              request, -1, outcome='error', peer=peer,
                              error=f'{type(e).__name__}: {e}')
                continue
            if gained == 'empty':
                # Reachable but cold: the admission's outcome is a miss
                # even if an earlier peer failed (journaled above).
                outcome = 'miss'
                continue
            if gained is None:
                # A version-skewed peer is backed off like a dead one.
                self._note_peer_failure(peer)
                outcome = 'mismatch'
                continue
            if gained == 'pool_exhausted':
                outcome = 'pool_exhausted'
                break
            self._peer_backoff_until.pop(peer, None)
            self._prefix_fetch_hits += 1
            self._prefix_fetch_tokens += gained
            self._count_prefix_fetch('hit')
            self._journal(journal.EventKind.ENGINE_PREFIX_FETCH, request,
                          -1, outcome='hit', peer=peer,
                          tokens_gained=gained, blocks_gained=gained // bk,
                          seconds=round(time.perf_counter() - t0, 6))
            return True
        self._prefix_fetch_misses += 1
        self._count_prefix_fetch(outcome)
        self._journal(journal.EventKind.ENGINE_PREFIX_FETCH, request, -1,
                      outcome=outcome, peers=len(peers_tried),
                      seconds=round(time.perf_counter() - t0, 6))
        return False

    def _install_remote_blocks(self, prompt_tokens: Sequence[int],
                               payload: dict, local_blocks: List[int],
                               m_full: int):
        """Validate and install one peer payload: allocate pool blocks,
        write the fetched K/V as they are (int8 values and scale planes
        included), publish the extended prefix to the radix cache.
        Returns the tokens gained, ``'empty'`` (the peer holds nothing
        past what we have: a miss, not a protocol error),
        ``'pool_exhausted'``, or None on a mismatch with this engine."""
        bk = self._block_k
        aligned = (len(prompt_tokens) // bk) * bk
        matched = int(payload.get('matched_tokens', 0))
        arrays = payload.get('arrays') or {}
        if matched <= m_full or not arrays:
            return 'empty'
        if (payload.get('block_k') != bk or
                payload.get('kv_cache_dtype') != self.dcfg.kv_cache_dtype
                or payload.get('from_tokens') != m_full
                or matched % bk or matched > aligned):
            return None
        if set(arrays) != set(self._cache):
            return None
        n_new = (matched - m_full) // bk
        for name, pool_arr in self._cache.items():
            a = arrays[name]
            want = (pool_arr.shape[0], n_new) + tuple(pool_arr.shape[2:])
            # The dtype must match exactly: bytes decoded under another
            # dtype would pass for plausible K/V.
            if (not isinstance(a, torch.Tensor) or tuple(a.shape) != want
                    or a.dtype != pool_arr.dtype):
                return None
        short = n_new - self._allocator.available()
        if short > 0:
            self._radix_evict(short)
        try:
            new_blocks = self._allocator.alloc(n_new)
        except PoolExhausted:
            return 'pool_exhausted'
        try:
            # The reference's power-of-two bucket names the shape (it
            # pads the scatter for jit); the port writes n_new blocks.
            bucket = 1
            while bucket < n_new:
                bucket *= 2
            self._note_compile('prefix_inject', blocks=bucket)
            decode.inject_pool_blocks(
                self._cache, self._dev(np.asarray(new_blocks, np.int64)),
                arrays)
            # Publish [0, matched): the cached part dedupes, the fetched
            # suffix is adopted (the tree takes its refs)...
            self._radix.insert(list(prompt_tokens[:matched]),
                               local_blocks[:m_full // bk] + new_blocks)
        except Exception:
            self._allocator.decref(new_blocks)
            raise
        # ...then drop our alloc refs: the tree owns the blocks, and the
        # caller's match again takes the request's own.
        self._allocator.decref(new_blocks)
        self._publish_block_gauges()
        return matched - m_full

    def _export_prefix_now(self, tokens: Sequence[int],
                           from_tokens: int = 0) -> Optional[dict]:
        """LOOP THREAD ONLY: radix-match ``tokens`` and copy the matched
        pool blocks past ``from_tokens`` to the host. None when nothing
        past ``from_tokens`` is cached."""
        if not self.paged:
            return None
        bk = self._block_k
        blocks, path = self._radix.match([int(t) for t in tokens])
        try:
            matched = len(blocks) * bk
            start = from_tokens // bk
            if matched <= from_tokens or start >= len(blocks):
                return None
            # The match's refs pin the blocks for the copy; the host copy
            # is a fresh buffer, safe to ship after they drop.
            return self._export_slot_blocks(blocks[start:], start * bk)
        finally:
            if blocks:
                self._allocator.decref(blocks)
            self._radix.release(path)

    def export_prefix_blocks(self, tokens: Sequence[int],
                             from_tokens: int = 0,
                             timeout: float = 2.0) -> Optional[dict]:
        """Cross-thread prefix export (the model server's
        ``/prefix_blocks``): queue a job the loop serves at its next step
        and wait at most ``timeout``. None on timeout or no match; the
        peer prefills locally either way."""
        job = {'tokens': list(tokens), 'from': int(from_tokens),
               'event': threading.Event(), 'result': None,
               # Past this the waiter is gone: skip the match and copy.
               'deadline': time.monotonic() + timeout}
        with self._export_lock:
            self._export_jobs.append(job)
        if job['event'].wait(timeout):
            return job['result']
        return None

    def _service_prefix_exports(self) -> None:
        """Serve the queued exports and handoff injections (loop thread,
        top of every step)."""
        with self._export_lock:
            if not self._export_jobs:
                return
            jobs, self._export_jobs = self._export_jobs, []
        for job in jobs:
            if job['deadline'] >= time.monotonic():
                try:
                    if job.get('kind') == 'inject':
                        job['result'] = self._inject_handoff_now(
                            job['tokens'], job['payload'])
                    else:
                        job['result'] = self._export_prefix_now(
                            job['tokens'], job['from'])
                except Exception as e:  # pylint: disable=broad-except
                    # Best effort for the peer: a failed read or install
                    # must not crash this engine's loop (the peer gets
                    # None, and a pushing peer degrades).
                    self._journal_raw(
                        journal.EventKind.ENGINE_PREFIX_FETCH,
                        {'outcome': 'export_error',
                         'error': f'{type(e).__name__}: {e}'})
                    job['result'] = None
            job['event'].set()

    def _publish_prompt(self, prompt: Sequence[int], m: int,
                        table: Sequence[int]) -> None:
        """A prefill is done: count it (``m`` tokens came from the prefix
        cache) and publish the prompt's whole blocks to the radix cache
        (a partial tail block and a copy-on-write clone stay private)."""
        self._count_prompt(prompt, m)
        full = len(prompt) // self._block_k
        if full:
            self._radix.insert(prompt[:full * self._block_k], table[:full])

    def _count_prompt(self, prompt: Sequence[int], m: int) -> None:
        if m:
            self._prompt_tokens_saved += m
            self._m.counter(
                'skytpu_engine_prefill_tokens_saved_total',
                'Prompt tokens NOT prefilled thanks to prefix-'
                'cache hits.').inc(m)
        self._prompt_tokens_total += len(prompt)

    def _prefill_range(self, prompt: Sequence[int], start: int, end: int,
                       table: Sequence[int],
                       chunk: Optional[int] = None) -> torch.Tensor:
        """Prefill prompt positions [start, end) into the pool blocks of
        ``table``, attending over positions [0, start) already there;
        returns the logits at ``end - 1``. One call serves a whole
        suffix and each chunk of a chunked admission (``chunk``, which
        the ``engine.compile`` shape then carries). The bucket's padding
        writes past ``end`` into the request's own blocks (or scratch);
        nothing attends there before the next chunk or decode step
        overwrites it."""
        bk = self._block_k
        suf = end - start
        bucket = self._bucket_for(suf)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :suf] = prompt[start:end]
        chunk_shape = {'chunk': chunk} if chunk else {}
        if start == 0:
            self._note_compile('paged_prefill', bucket=bucket,
                               **chunk_shape)
            row = np.full((bucket // bk,), SCRATCH_BLOCK, np.int64)
            nrow = min(len(table), len(row))
            row[:nrow] = table[:nrow]
            return decode.paged_prefill(
                self.params, self._dev(padded), suf, self._dev(row),
                self.cfg, self._cache)
        # Prefix block count buckets to powers of two (the reference's
        # compile bound; padding rows point at scratch and are masked by
        # prefix_len).
        npb = -(-start // bk)
        npb_bucket = 1
        while npb_bucket < npb:
            npb_bucket *= 2
        self._note_compile('paged_prefill_with_prefix', bucket=bucket,
                           npb_bucket=npb_bucket, **chunk_shape)
        pref = np.full((npb_bucket,), SCRATCH_BLOCK, np.int64)
        pref[:npb] = table[:npb]
        # Writes start inside block start // bk at offset start % bk, so
        # the row holds one block more than the bucket.
        srow = start // bk
        row = np.full((bucket // bk + 1,), SCRATCH_BLOCK, np.int64)
        avail = table[srow:srow + len(row)]
        row[:len(avail)] = avail
        return decode.paged_prefill_with_prefix(
            self.params, self._dev(padded), suf, start, self._dev(pref),
            self._dev(row), self.cfg, self._cache)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _bucket_for(self, n: int) -> int:
        """Smallest prefill bucket covering ``n`` tokens (ValueError —
        a journaled reject, not a dead loop — when none does)."""
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(f'no prefill bucket >= {n} '
                         f'(buckets: {self._buckets})')

    def _sample_first(self, last_logits: torch.Tensor) -> int:
        return int(decode.sample(last_logits[None], self._generator,
                                 self.dcfg.temperature)[0])

    def _admit(self) -> int:
        """Fill free slots from the tenant queues (round-robin); over-
        budget requests are clamped (budget) or rejected (prompt too
        long), each with a journaled ``engine.reject``. Returns
        admissions made. A crash mid-admission finishes the popped
        request as an error before it propagates: it is neither queued
        nor slotted, so nothing else would answer it."""
        n = 0
        self._admitting = True
        try:
            while self.free_slots():
                req = self._pop_next()
                if req is None:
                    break
                self._publish_queue_depth()
                p = len(req.prompt)
                budget = self.dcfg.max_len - p
                if self.paged:
                    # A reservation larger than the whole pool would
                    # requeue forever.
                    budget = min(budget,
                                 (self.num_blocks - 1) * self._block_k - p)
                if budget < 1:
                    self._reject(req, 'prompt_too_long', prompt_len=p,
                                 max_len=self.dcfg.max_len)
                    continue
                if req.max_new_tokens > budget:
                    # Clamp rather than reject: only the generation
                    # budget overshoots. Journaled so the truncation is
                    # attributable after the fact.
                    self._journal(journal.EventKind.ENGINE_REJECT, req, -1,
                                  action='clamp', prompt_len=p,
                                  requested=req.max_new_tokens,
                                  clamped_to=budget)
                    req.max_new_tokens = budget
                try:
                    self.insert(req)
                    n += 1
                except PoolExhausted:
                    # Blocks are busy: head-of-line waits for an eviction.
                    self._requeue_front(req)
                    break
                except ValueError as e:
                    self._reject(req, f'error: {e}')
                except Exception as e:
                    self._fail_request(req, f'admission crashed: {e}')
                    raise
        finally:
            self._admitting = False
        return n

    def _reject(self, req: Request, reason: str, **payload) -> None:
        """Terminal rejection, the request's fault (a 4xx)."""
        self._finish_unadmitted(req, f'rejected: {reason}',
                                action='reject', reason=reason, **payload)

    def _fail_request(self, req: Request, reason: str, **payload) -> None:
        """Terminal server-side failure of a request that never got a
        slot: 'error: ...', which the server answers with a 500."""
        self._finish_unadmitted(req, f'error: {reason}',
                                action='error', reason=reason, **payload)

    def _finish_unadmitted(self, req: Request, finish_reason: str,
                           **payload) -> None:
        self._journal(journal.EventKind.ENGINE_REJECT, req, -1, **payload)
        self._rejected += 1
        self._m.counter('skytpu_engine_rejected_total',
                        'Requests rejected at admission.').inc()
        req._finish(finish_reason)  # pylint: disable=protected-access
        self._finish_telemetry(req, -1, req.finish_reason)

    def _finish_telemetry(self, req: Request, slot: int,
                          reason: str) -> None:
        """Freeze the request's phase record; an SLO breach journals
        ``engine.slow_request`` under its trace id."""
        slow = self.telemetry.on_finish(req, reason)
        if slow is not None:
            self._journal(journal.EventKind.ENGINE_SLOW_REQUEST, req, slot,
                          **slow)

    # ------------------------------------- disaggregated prefill/decode

    def _count_handoff(self, result: str) -> None:
        self._m.counter(
            'skytpu_engine_handoffs_total',
            'Full-request KV handoff attempts by outcome.',
            labels=('result',)).inc(labels=(result,))

    def _handoff_degrade(self, req: Request, reason: str,
                         **payload) -> None:
        """One degraded handoff: the request decodes in place on this
        (prefill) replica, counted and journaled. Degrading is the only
        failure mode: a handoff never turns into a hung stream."""
        self._handoffs_degraded += 1
        self._count_handoff('degraded')
        self._journal(journal.EventKind.ENGINE_HANDOFF, req, -1,
                      outcome='degraded', reason=reason, **payload)

    def _export_slot_blocks(self, send: List[int],
                            from_tokens: int) -> dict:
        """LOOP THREAD ONLY: copy an explicit block list to the host in the
        wire format's fields: a radix match's blocks (the export) or a
        still-prefilling slot's (the handoff; they are not in the radix
        cache yet, and ``_slot_refs`` pins them). The copy is a fresh host
        buffer, so the push thread never sees a pool block the next chunk
        overwrites."""
        bucket = 1
        while bucket < len(send):
            bucket *= 2
        self._note_compile('prefix_export', blocks=bucket)
        arrays = decode.export_pool_blocks(
            self._cache, self._dev(np.asarray(send, np.int64)))
        return {
            'matched_tokens': from_tokens + len(send) * self._block_k,
            'from_tokens': from_tokens,
            'block_k': self._block_k,
            'kv_cache_dtype': self.dcfg.kv_cache_dtype,
            'arrays': arrays,
        }

    def _handoff_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        """Lazy: an engine that never hands off never starts the
        threads."""
        if self._handoff_pool is None:
            self._handoff_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(2, min(self.num_slots, 8)),
                thread_name_prefix=f'{self.name}-handoff')
        return self._handoff_pool

    def _shutdown_handoff_executor(self) -> None:
        """Stop the pushes' threads (loop end, supervisor restart). A push
        already on the wire runs out its own budget; it holds only a host
        snapshot and the transport, never the engine or the pool."""
        pool, self._handoff_pool = self._handoff_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def _await_handoff_ack(self, st: dict) -> bool:
        """Resolve the slot's in-flight push, if any. On an ack the pushed
        watermark advances and the peer's backoff clears; on a failure or
        timeout the slot degrades to decode-in-place and the peer backs
        off. Returns whether the handoff is still live."""
        pend = st.pop('hand_fut', None)
        if pend is None:
            return not st.get('hand_failed')
        fut, end_blocks, prev = pend
        req = st['req']
        bk = self._block_k
        budget = env.env_float(prefix_transfer.PUSH_BUDGET_ENV,
                               prefix_transfer.DEFAULT_PUSH_BUDGET_SECONDS)
        try:
            # The transport's budget bounds the push; this outer timeout
            # only catches a wedged transport (an abandoned future holds
            # a snapshot, nothing of the pool).
            ok = bool(fut.result(timeout=max(2.0 * budget, 1.0)))
            err = None
        except Exception as e:  # pylint: disable=broad-except
            ok = False
            err = f'{type(e).__name__}: {e}'
        if ok:
            st['pushed'] = end_blocks
            self._handoff_tokens_pushed += (end_blocks - prev) * bk
            if req.handoff_peer:
                self._peer_backoff_until.pop(req.handoff_peer, None)
            return True
        st['hand_failed'] = True
        if req.handoff_peer:
            self._note_peer_failure(req.handoff_peer)
        self._handoff_degrade(req, 'push_failed', error=err,
                              peer=req.handoff_peer,
                              tokens_pushed=st['pushed'] * bk)
        return False

    def _push_handoff_chunk(self, st: dict) -> None:
        """The prefill side: push the slot's newly finished FULL blocks to
        the decode peer. The partial tail block never ships: the decode
        replica prefills the unaligned suffix itself, so its first token
        samples from logits it computed, as monolithic serving's does.

        Double-buffered: the device read happens here on the loop thread
        and the transfer on the handoff executor, so chunk k streams
        while chunk k+1 prefills. At most one push is in flight per slot
        (the previous ack is awaited before the next export), which keeps
        the payloads in order (the decode side refuses a gap) and bounds
        host memory to one chunk of blocks. Any failure degrades the
        slot and backs the peer off; nothing raises into the step."""
        req = st['req']
        bk = self._block_k
        end_blocks = min(st['next'], st['p']) // bk
        if not self._await_handoff_ack(st):
            return
        pushed = st['pushed']
        if end_blocks <= pushed:
            return
        send = st['table'][pushed:end_blocks]
        try:
            payload = self._export_slot_blocks(send, pushed * bk)
        except Exception as e:  # pylint: disable=broad-except
            st['hand_failed'] = True
            if req.handoff_peer:
                self._note_peer_failure(req.handoff_peer)
            self._handoff_degrade(req, 'push_failed',
                                  error=f'{type(e).__name__}: {e}',
                                  peer=req.handoff_peer,
                                  tokens_pushed=pushed * bk)
            return
        st['hand_fut'] = (
            self._handoff_executor().submit(
                req.handoff_push, req.prompt[:end_blocks * bk], payload),
            end_blocks, pushed)

    def inject_handoff_blocks(self, tokens: Sequence[int], payload: dict,
                              timeout: float = 5.0) -> dict:
        """Cross-thread handoff injection (the model server's
        ``/handoff_blocks``): queue the pushed blocks for the loop to
        install at its next step and wait at most ``timeout``. Returns
        ``{'ok': bool, ...}``; a reply that is not ok makes the prefill
        side degrade. The ``handoff_decode_death`` chaos point fires
        here."""
        chaos.maybe_raise('handoff_decode_death')
        if not self.paged:
            return {'ok': False, 'error': 'not_paged'}
        job = {'kind': 'inject', 'tokens': list(tokens),
               'payload': payload, 'event': threading.Event(),
               'result': None,
               'deadline': time.monotonic() + timeout}
        with self._export_lock:
            self._export_jobs.append(job)
        if job['event'].wait(timeout):
            res = job['result']
            if res is None:
                return {'ok': False, 'error': 'inject_failed'}
            return res
        return {'ok': False, 'error': 'timeout'}

    def _inject_handoff_now(self, tokens: List[int],
                            payload: dict) -> dict:
        """LOOP THREAD ONLY: install one pushed chunk. Incremental and
        idempotent against the radix cache: the pushed blocks extend the
        prefix already cached for these tokens (a push that is already
        covered is an ok no-op; one whose ``from_tokens`` lies past the
        coverage would leave a hole and is refused as a ``gap``). The
        validation (dtype, shapes, block_k) is the fetch's,
        :meth:`_install_remote_blocks`. The match's refs come back on
        every path."""
        bk = self._block_k
        tokens = [int(t) for t in tokens]
        try:
            matched = int(payload.get('matched_tokens', 0))
            from_tokens = int(payload.get('from_tokens', 0))
        except (TypeError, ValueError):
            matched = from_tokens = -1
        if (matched <= 0 or matched % bk or from_tokens < 0
                or from_tokens % bk or matched > len(tokens)):
            return self._handoff_inject_result(
                {'ok': False, 'error': 'malformed'})
        blocks, path = self._radix.match(tokens[:matched])
        m_d = len(blocks) * bk
        try:
            if matched <= m_d:
                # Already covered (an earlier push, or a warm cache).
                return self._handoff_inject_result({'ok': True,
                                                    'gained': 0})
            if from_tokens > m_d:
                # The push assumes blocks that were never installed (a
                # lost earlier chunk): refusing keeps the tree hole-free.
                return self._handoff_inject_result(
                    {'ok': False, 'error': 'gap'})
            skip = (m_d - from_tokens) // bk
            arrays = payload.get('arrays') or {}
            if skip:
                arrays = {name: a[:, skip:] for name, a in arrays.items()}
            gained = self._install_remote_blocks(
                tokens[:matched], dict(payload, arrays=arrays,
                                       from_tokens=m_d), blocks, m_d)
        finally:
            self._allocator.decref(blocks)
            self._radix.release(path)
        if gained == 'empty':
            return self._handoff_inject_result({'ok': True, 'gained': 0})
        if gained == 'pool_exhausted' or gained is None:
            return self._handoff_inject_result(
                {'ok': False, 'error': gained or 'mismatch'})
        self._handoff_injections += 1
        self._handoff_tokens_injected += gained
        return self._handoff_inject_result({'ok': True, 'gained': gained})

    def _handoff_inject_result(self, res: dict) -> dict:
        result = 'inject' if res.get('ok') else 'inject_error'
        self._count_handoff(result)
        self._journal_raw(journal.EventKind.ENGINE_HANDOFF,
                          {'outcome': result,
                           **{k: v for k, v in res.items() if k != 'ok'}})
        return res

    # -------------------------------------------------- chunked prefill

    def _advance_prefill(self) -> int:
        """Advance every prefilling slot by one chunk; returns the prefill
        tokens processed. The bound is per prompt, not global, so a burst
        of long prompts still prefills in parallel."""
        total = 0
        for slot, st in enumerate(self._prefill_state):
            if st is not None:
                total += self._advance_prefill_slot(slot, st)
        return total

    def _advance_prefill_slot(self, slot: int, st: dict) -> int:
        """Run one chunk of one slot's pending prefill; returns its token
        count. Positions [0, next) already in the pool are the chunk's
        prefix, exactly as a radix hit's are."""
        start = st['next']
        chunk = st.get('chunk') or self.prefill_chunk
        end = min(start + chunk, st['p'])
        last = self._prefill_range(st['req'].prompt, start, end,
                                   st['table'], chunk=chunk)
        st['next'] = end
        self._prefill_chunks += 1
        self._m.counter(
            'skytpu_engine_prefill_chunks_total',
            'Prefill chunks executed by chunked admissions.').inc()
        if st.get('hand') and not st.get('hand_failed'):
            # Stream the chunk's newly finished full blocks before the
            # finish check: by _finish_prefill every aligned block was
            # acked, or the slot has degraded to decode-in-place.
            self._push_handoff_chunk(st)
        if end >= st['p']:
            self._finish_prefill(slot, st, last)
        return end - start

    def _finish_prefill(self, slot: int, st: dict,
                        last: torch.Tensor) -> None:
        """Last chunk done: publish the prompt to the prefix cache,
        install the real table row, deliver the first token and join the
        decode lanes. A live handoff instead awaits its last ack and
        finishes the request as ``'handoff'``: no radix publish and no
        first token here, and every reserved block goes back to the
        pool, so the prefill tier's pool turns over."""
        req, table = st['req'], st['table']
        if st.get('hand') and not st.get('hand_failed'):
            # An unacked tail would hand the stream to a peer that never
            # got it: a failure here degrades and falls through.
            self._await_handoff_ack(st)
        if st.get('hand') and not st.get('hand_failed'):
            self._count_prompt(req.prompt, st['m'])
            self._handoffs_completed += 1
            self._count_handoff('complete')
            self._journal(journal.EventKind.ENGINE_HANDOFF, req, slot,
                          outcome='complete',
                          tokens_pushed=st['pushed'] * self._block_k,
                          peer=req.handoff_peer)
            self._evict(slot, 'handoff')
            return
        self._publish_prompt(req.prompt, st['m'], table)
        self._block_table_np[slot, :] = SCRATCH_BLOCK
        self._block_table_np[slot, :len(table)] = table
        self._block_table_dev = None
        self._prefill_state[slot] = None
        self._publish_block_gauges()
        self._deliver_first(slot, req, self._sample_first(last))

    # -------------------------------------------------------------- step

    def step(self) -> int:
        """Admit, advance each chunked admission by one chunk, then run
        ``step_chunk`` decode steps across all slots, or one speculative
        round when ``spec_k > 0``. Returns the number of active slots
        (0 = idle)."""
        # Chaos points (off unless SKYTPU_CHAOS arms them): an injected
        # raise exercises the supervisor; slow_step widens decode windows.
        chaos.maybe_raise('engine_step_raise')
        chaos.maybe_slow_step()
        # Peers' /prefix_blocks exports, before admission, so a prefix
        # published last step is exportable at once.
        self._service_prefix_exports()
        self._admit()
        active = self.active_slots()
        if active == 0:
            return 0
        t0 = time.perf_counter()
        # One chunk per prefilling slot BEFORE the decode dispatch. With
        # no lane decoding there is nothing to hold up: keep prefilling
        # until a lane is ready instead of idling a step per chunk.
        pf_tokens = self._advance_prefill()
        decode_lanes = int(np.count_nonzero(~self._done))
        while (decode_lanes == 0 and
               any(st is not None for st in self._prefill_state)):
            pf_tokens += self._advance_prefill()
            decode_lanes = int(np.count_nonzero(~self._done))
        emitted_before = self._decode_emitted
        n = 0
        if decode_lanes:
            # Token latency is observed over the decode dispatch only: the
            # chunked-prefill share of the step is admission work.
            t_dec = time.perf_counter()
            if self.dcfg.spec_k:
                n = 1
                self._spec_round()
                # One round replaces a variable number of per-lane steps:
                # normalise by the mean tokens delivered per live lane.
                per_token_div = max(
                    (self._decode_emitted - emitted_before)
                    / decode_lanes, 1.0)
            else:
                n = self._decode_round()
                per_token_div = float(n)
            self._m.histogram(
                'skytpu_engine_token_seconds',
                'Per-token decode step latency.',
                buckets=runtime_metrics.TOKEN_LATENCY_BUCKETS
            ).observe((time.perf_counter() - t_dec) / per_token_div)
        stall = self.profiler.record(
            time.perf_counter() - t0, chunk=n, active=active,
            delivered=self._decode_emitted - emitted_before,
            queue_depth=self._publish_queue_depth(),
            blocks_used=self._allocator.used() if self.paged else 0,
            blocks_total=(self.num_blocks - 1) if self.paged else 0,
            prefill_tokens=pf_tokens)
        if stall is not None:
            self._journal_raw(journal.EventKind.ENGINE_STALL, stall)
        # Refill freed lanes now so the next chunk runs full. The journal
        # write rides a background thread: a stalled journal disk never
        # blocks the step loop.
        self._admit()
        self.flush_journal(wait=False)
        return active

    def _tables_dev(self) -> torch.Tensor:
        if self._block_table_dev is None:
            self._block_table_dev = self._dev(self._block_table_np)
        return self._block_table_dev

    def _decode_round(self) -> int:
        """``step_chunk`` single-token steps over every slot, then one
        host fetch and delivery; returns the steps run. Per-step
        semantics are the reference's ``_scan_engine_steps``: sample →
        EOS-force → done-fold, one budget unit per live step, done lanes
        freeze their position."""
        eos = self.dcfg.eos_id
        self._note_compile('decode_steps', n_steps=self.step_chunk,
                           paged=self.paged)
        token = self._dev(self._token)
        pos = self._dev(self._pos)
        done = self._dev(self._done)
        remaining = self._dev(self._remaining)
        tables = self._tables_dev() if self.paged else None
        toks = []
        for _ in range(self.step_chunk):
            if self.paged:
                logits = decode.paged_decode_step(
                    self.params, token, pos, tables, self.cfg, self.dcfg,
                    self._cache)
            else:
                logits = decode.decode_step(self.params, token, pos,
                                            self.cfg, self.dcfg,
                                            self._cache)
            nxt = decode.sample(logits, self._generator,
                                self.dcfg.temperature)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done_new = done | (nxt == eos)
            else:
                nxt = torch.where(done, token, nxt)
                done_new = done
            remaining = remaining - (~done).long()
            done_new = done_new | (remaining <= 0)
            pos = torch.where(done, pos, pos + 1)
            token, done = nxt, done_new
            toks.append(nxt)
        # One fused host fetch (the step's only sync point).
        host = torch.cat([torch.stack(toks).flatten(), token, pos,
                          done.long(), remaining]).cpu().numpy()
        n, b = self.step_chunk, self.num_slots
        toks_np = host[:n * b].reshape(n, b)
        self._token, self._pos, done_np, self._remaining = (
            host[n * b + i * b:n * b + (i + 1) * b].copy()
            for i in range(4))
        self._done = done_np.astype(bool)
        # Counted before delivery: a client woken by its last token may
        # read stats() or /metrics at once.
        self._count_steps(n)
        self._deliver_chunk(toks_np)
        return n

    def _count_steps(self, n: int) -> None:
        self._decode_steps += n
        self._m.counter('skytpu_engine_steps_total',
                        'Batched decode steps executed.').inc(n)

    def _spec_round(self) -> None:
        """One speculative draft + batched-verify round across all lanes,
        with host-side accept and rollback.

        Acceptance is the chain rule: verify token ``i`` is the full
        model's argmax given the drafted context up to ``i``, which is
        the true greedy context while every earlier draft was accepted —
        so delivering the accepted run plus one correction (or bonus)
        token emits exactly what the non-speculative path would. Rollback
        is positional: ``pos`` advances by the delivered count only; the
        rejected tail's cache entries lie past ``pos``, are never
        attended, and are overwritten when a real token reaches them.
        Idle lanes run too (their tables are all scratch) and deliver
        nothing."""
        tables = self._tables_dev()
        k = self.dcfg.spec_k
        # The drafter attends positions < pos only: gather just the live
        # blocks (power-of-two bucketed, as the reference bounds its
        # compiles). Verify keeps the full tables.
        live = ~self._done
        max_pos = int(self._pos[live].max()) if live.any() else 1
        npb = max(1, -(-max_pos // self._block_k))
        nb_bucket = 1
        while nb_bucket < npb:
            nb_bucket *= 2
        nb_bucket = min(nb_bucket, self._max_blocks)
        self._note_compile('spec_step', spec_k=k,
                           drafter_layers=self.dcfg.spec_drafter_layers,
                           draft_blocks=nb_bucket)
        drafts, vtok = _spec_step(self.params, self._dev(self._token),
                                  self._dev(self._pos),
                                  tables[:, :nb_bucket], tables,
                                  self._cache, self.cfg, self.dcfg)
        # One host fetch per round.
        host = torch.cat([drafts, vtok], dim=1).cpu().numpy()
        drafts, vtok = host[:, :k], host[:, k:]
        runs = []
        for slot, req in enumerate(self._slots):
            if req is None or self._done[slot]:
                continue
            n_acc = 0
            while n_acc < k and drafts[slot, n_acc] == vtok[slot, n_acc]:
                n_acc += 1
            runs.append((slot, req, n_acc))
        # Counted before delivery: a client woken by its last token may
        # read stats() or /metrics at once.
        self._count_steps(1)
        round_drafted = k * len(runs)
        round_accepted = sum(n for _, _, n in runs)
        self._spec_drafted += round_drafted
        self._spec_accepted += round_accepted
        self._m.counter(
            'skytpu_engine_spec_drafted_total',
            'Tokens proposed by the speculative drafter.').inc(
                round_drafted)
        self._m.counter(
            'skytpu_engine_spec_accepted_total',
            'Drafted tokens accepted by the batched verify.').inc(
                round_accepted)
        self._m.gauge(
            'skytpu_engine_spec_accept_ratio',
            'Cumulative accepted/drafted ratio of the speculative '
            'path.').set(self.spec_accept_ratio())
        for slot, req, n_acc in runs:
            delivered, last_tok, evicted = self._deliver_run(
                slot, req, vtok[slot, :n_acc + 1])
            self._decode_emitted += delivered
            if not evicted:
                self._token[slot] = last_tok
                self._pos[slot] += delivered
                self._remaining[slot] -= delivered

    def _deliver_run(self, slot: int, req: Request,
                     tokens) -> Tuple[int, int, bool]:
        """Deliver a run of tokens to one lane with budget/EOS clipping;
        evicts on a terminal condition. The one copy of the finish
        semantics, shared by the decode round and the speculative accept
        path. Returns (tokens delivered, the last one, evicted?)."""
        eos = self.dcfg.eos_id
        budget = req.max_new_tokens - len(req.tokens)
        reason = None
        run: List[int] = []
        for t in tokens:
            run.append(int(t))
            if eos is not None and run[-1] == eos:
                reason = 'eos'
            elif len(run) >= budget:
                reason = 'length'
            if reason is not None:
                break
        # Counted before delivery: a client woken by its last token may
        # read /metrics at once.
        self._count_tokens(len(run))
        for i, t in enumerate(run):
            done = reason is not None and i == len(run) - 1
            if done:
                # Publish the reason before the terminal token.
                req.finish_reason = reason
            req._deliver(t, done=done)  # pylint: disable=protected-access
        if reason is not None:
            self._evict(slot, reason)
        return len(run), run[-1] if run else 0, reason is not None

    def _deliver_chunk(self, toks_np: np.ndarray) -> None:
        for slot, req in enumerate(self._slots):
            # A slot mid-chunked-prefill is not decoding yet: its frozen
            # lane's outputs are scratch noise, not tokens.
            if req is not None and self._prefill_state[slot] is None:
                self._decode_emitted += self._deliver_run(
                    slot, req, toks_np[:, slot])[0]

    def _evict(self, slot: int, reason: str) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        if self.paged:
            # Drop the request's refs (prefix-cache blocks survive) and
            # repoint the row at scratch so the frozen lane's writes can
            # never land in a block reallocated to someone else.
            self._allocator.decref(self._slot_refs[slot])
            self._radix.release(self._slot_nodes[slot])
            self._slot_refs[slot] = []
            self._slot_nodes[slot] = []
            self._prefill_state[slot] = None
            self._block_table_np[slot, :] = SCRATCH_BLOCK
            self._block_table_dev = None
            self._publish_block_gauges()
        self._count_evicted()
        self._journal(journal.EventKind.ENGINE_EVICT, req, slot,
                      reason=reason, generated=len(req.tokens))
        req._finish(reason)  # pylint: disable=protected-access
        self._finish_telemetry(req, slot, reason)
        self._publish_slot_gauges()

    def _count_evicted(self) -> None:
        self._evicted += 1
        self._m.counter('skytpu_engine_evicted_total',
                        'Requests evicted from a slot (finished).').inc()

    # ------------------------------------------------------------- loop

    def run_forever(self, stop_event: threading.Event) -> None:
        """Supervised engine loop: step while there is work, wait briefly
        when idle, until ``stop_event``. Every iteration beats the
        profiler's heartbeat (``/healthz`` staleness reads it). A
        ``step()`` exception goes to :meth:`_recover_from_crash`, which
        fails the in-flight requests, rebuilds and restarts within the
        budget, or else fails the engine for good and ends the loop."""
        idle = env.env_float(IDLE_SLEEP_ENV, 0.02)
        try:
            while not stop_event.is_set():
                self.profiler.beat()
                try:
                    active = self.step()
                except Exception as exc:  # pylint: disable=broad-except
                    if not self._recover_from_crash(exc):
                        return
                    continue
                if active == 0:
                    # One-token admissions while idle (non-blocking: the
                    # idle loop keeps beating through a journal stall).
                    self.flush_journal(wait=False)
                    stop_event.wait(idle)
        finally:
            # The pushes' threads must not outlive the loop that owns
            # them.
            self._shutdown_handoff_executor()

    # ------------------------------------------------------- supervision

    def restart_count(self) -> int:
        return self._restarts

    def _recover_from_crash(self, exc: BaseException) -> bool:
        """One supervisor round: journal the crash with its traceback
        (``engine.crash``), fail the in-flight requests, then rebuild and
        restart (True) or, past
        ``SKYTPU_ENGINE_MAX_RESTARTS`` crashes within
        ``SKYTPU_ENGINE_RESTART_WINDOW_SECONDS``, fail the queued
        requests too and mark the engine failed for good (False). A
        sticky CUDA error poisons the context, so every rebuild then
        fails again and the budget runs out: the replica is replaced,
        not reset in place."""
        now = time.time()
        window = env.env_float(RESTART_WINDOW_ENV,
                               DEFAULT_RESTART_WINDOW_SECONDS)
        budget = env.env_int(MAX_RESTARTS_ENV, DEFAULT_MAX_RESTARTS)
        self._crash_times = [t for t in self._crash_times
                             if now - t <= window]
        self._crash_times.append(now)
        permanent = len(self._crash_times) > budget
        exc_text = str(exc) or type(exc).__name__
        self._journal_raw(journal.EventKind.ENGINE_CRASH, {
            'error': exc_text,
            'traceback': ''.join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            'in_flight': self.active_slots(),
            'queued': self.queue_depth(),
            'crashes_in_window': len(self._crash_times),
            'max_restarts': budget,
            'permanent': permanent,
        })
        self._fail_in_flight(f'error: engine crashed: {exc_text}')
        if permanent:
            self.failed = True
            self.fail_reason = (
                f'{len(self._crash_times)} crashes within {window:.0f}s '
                f'(budget {budget}); last: {exc_text}')
            self._fail_queued()
            self.flush_journal()
            return False
        # The traceback's frames may hold the old cache (a crash inside a
        # decode call): clear them so the rebuild can reuse its memory.
        traceback.clear_frames(exc.__traceback__)
        # A push still in flight belongs to a failed request: its state
        # goes with the old pool, and its thread holds only a snapshot.
        self._shutdown_handoff_executor()
        self._init_runtime_state()
        self._restarts += 1
        self._m.counter(
            'skytpu_engine_restarts_total',
            'Engine supervisor restarts after a step() crash.').inc()
        self._journal_raw(journal.EventKind.ENGINE_RESTART, {
            'restarts': self._restarts,
            'queued': self.queue_depth(),
        })
        self.flush_journal()
        self._publish_slot_gauges()
        if self.paged:
            self._publish_block_gauges()
        return True

    def _fail_in_flight(self, reason: str) -> None:
        """Finish every slotted request with an error now (the server
        answers 500), leaving the allocator and radix cache alone: the
        crash may have left them inconsistent, and the caller rebuilds
        them."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._slots[slot] = None
            self._prefill_state[slot] = None
            self._count_evicted()
            self._journal(journal.EventKind.ENGINE_EVICT, req, slot,
                          reason=reason, generated=len(req.tokens))
            req._finish(reason)  # pylint: disable=protected-access
            self._finish_telemetry(req, slot, reason)
        self._publish_slot_gauges()

    def _fail_queued(self) -> None:
        """Permanent failure only: nothing will serve the queue again."""
        while True:
            req = self._pop_next()
            if req is None:
                break
            self._fail_request(req, 'engine failed permanently')
        self._publish_queue_depth()

    # ------------------------------------------------------------ stats

    def mean_occupancy(self) -> float:
        """Delivered decode tokens / executed lane-steps."""
        lane_steps = self._decode_steps * self.num_slots
        return self._decode_emitted / lane_steps if lane_steps else 0.0

    def spec_accept_ratio(self) -> float:
        """Cumulative accepted/drafted ratio of the speculative path (0.0
        while nothing was drafted)."""
        if not self._spec_drafted:
            return 0.0
        return self._spec_accepted / self._spec_drafted

    def spec_stats(self) -> dict:
        """The ``/slo`` ``spec`` block: speculative-decoding and
        chunked-prefill counters of this engine."""
        return {
            'enabled': self.dcfg.spec_k > 0,
            'spec_k': self.dcfg.spec_k,
            'drafter_layers': self.dcfg.spec_drafter_layers,
            'drafted_total': self._spec_drafted,
            'accepted_total': self._spec_accepted,
            'accept_ratio': round(self.spec_accept_ratio(), 4),
            'prefill_chunk': self.prefill_chunk,
            'prefill_chunks_total': self._prefill_chunks,
            'chunked_admissions': self._chunked_admissions,
        }

    def prefix_hit_ratio(self) -> float:
        if not self.paged or not self._prompt_tokens_total:
            return 0.0
        return self._prompt_tokens_saved / self._prompt_tokens_total

    def cache_stats(self) -> dict:
        """The ``/slo`` ``cache`` block: prefix-cache locality and pressure
        counters, and the peer tier's. The store tier is not ported: its
        fields read as the reference's do with it off."""
        return {
            'paged': self.paged,
            'prefix_hit_ratio': round(self.prefix_hit_ratio(), 4),
            'prefill_tokens_saved': self._prompt_tokens_saved,
            'prompt_tokens_total': self._prompt_tokens_total,
            'prefix_cache_blocks': (self._radix.held_blocks()
                                    if self.paged else 0),
            'radix_nodes': self._radix.node_count() if self.paged else 0,
            'prefix_evictions': self._prefix_evictions,
            'prefix_fetch_hits': self._prefix_fetch_hits,
            'prefix_fetch_misses': self._prefix_fetch_misses,
            'prefix_fetch_tokens': self._prefix_fetch_tokens,
            'prefix_peers': len(self.prefix_peers),
            'store_configured': False,
            'store_in_backoff': False,
            'store_fetch_hits': 0,
            'store_fetch_misses': 0,
            'store_fetch_tokens': 0,
            'store_spills': 0,
            'store_spill_tokens': 0,
            'store_spill_failures': 0,
            'store_spill_drops': 0,
        }

    def handoff_stats(self) -> dict:
        """The ``/slo`` ``handoff`` block: the disaggregated prefill/decode
        counters of this engine, both directions (loop-owned ints, read
        stale by a tick at worst)."""
        return {
            'completed': self._handoffs_completed,
            'degraded': self._handoffs_degraded,
            'tokens_pushed': self._handoff_tokens_pushed,
            'injections': self._handoff_injections,
            'tokens_injected': self._handoff_tokens_injected,
        }

    def stats(self) -> dict:
        self.flush_journal()
        out = {
            'num_slots': self.num_slots,
            'active_slots': self.active_slots(),
            'queue_depth': self.queue_depth(),
            'admitted': self._admitted,
            'evicted': self._evicted,
            'rejected': self._rejected,
            'decode_steps': self._decode_steps,
            'decode_tokens': self._decode_emitted,
            'mean_occupancy': round(self.mean_occupancy(), 4),
            'stalls': self.profiler.stall_count(),
            'restarts': self._restarts,
            'failed': self.failed,
            'step_chunk': self.step_chunk,
            'kv_cache_dtype': self.dcfg.kv_cache_dtype,
            'max_len': self.dcfg.max_len,
            'paged': self.paged,
            'tp': 1,
            'device': str(self.device),
            'decode_attention': self.dcfg.decode_attention,
        }
        if self.paged:
            out.update({
                'block_k': self._block_k,
                'blocks_total': self.num_blocks - 1,
                'blocks_used': self._allocator.used(),
                'prefix_cache_blocks': self._radix.held_blocks(),
                'prefix_hit_ratio': round(self.prefix_hit_ratio(), 4),
                'prefill_tokens_saved': self._prompt_tokens_saved,
                'prefill_chunk': self.prefill_chunk,
                'prefill_chunks': self._prefill_chunks,
                'chunked_admissions': self._chunked_admissions,
                'prefix_evictions': self._prefix_evictions,
                'prefix_fetch_hits': self._prefix_fetch_hits,
                'prefix_fetch_misses': self._prefix_fetch_misses,
                'handoffs_completed': self._handoffs_completed,
                'handoffs_degraded': self._handoffs_degraded,
                'handoff_injections': self._handoff_injections,
                # The store tier is not ported yet: read as the
                # reference's with it off.
                'store_configured': False,
                'store_fetch_hits': 0,
                'store_spills': 0,
            })
        if self.dcfg.spec_k:
            out.update({
                'spec_k': self.dcfg.spec_k,
                'spec_drafted': self._spec_drafted,
                'spec_accepted': self._spec_accepted,
                'spec_accept_ratio': round(self.spec_accept_ratio(), 4),
            })
        return out

    # ---------------------------------------------------------- plumbing

    def _publish_slot_gauges(self) -> None:
        self._m.gauge('skytpu_engine_active_slots',
                      'Slots currently decoding.').set(self.active_slots())
        self._m.gauge(
            'skytpu_engine_slot_occupancy',
            'Measured decode-lane occupancy (delivered tokens / '
            'lane-steps).').set(self.mean_occupancy())

    def _publish_block_gauges(self) -> None:
        self._m.gauge('skytpu_engine_blocks_total',
                      'Usable KV pool blocks (scratch excluded).').set(
                          self.num_blocks - 1)
        self._m.gauge('skytpu_engine_blocks_used',
                      'KV pool blocks currently referenced (slots or '
                      'prefix cache).').set(self._allocator.used())
        self._m.gauge(
            'skytpu_engine_prefix_hit_ratio',
            'Cumulative fraction of prompt tokens served from the '
            'prefix cache.').set(self.prefix_hit_ratio())
        self._m.gauge(
            'skytpu_engine_radix_nodes',
            'Edges in the radix prefix tree.').set(
                self._radix.node_count())
        self._m.gauge(
            'skytpu_engine_prefix_cache_blocks',
            'KV pool blocks held by the radix prefix cache.').set(
                self._radix.held_blocks())

    def _note_compile(self, kind: str, **shape) -> None:
        """Journal ``engine.compile`` once per distinct dispatch shape,
        just before its first dispatch, with the reference's kinds and
        keys. The port runs eagerly: the row marks the first launch of a
        shape (where a CUDA-graph capture would happen), not a trace.
        The dedupe set survives supervisor restarts."""
        key = (kind, tuple(sorted(shape.items())))
        if key in self._traced_shapes:
            return
        self._traced_shapes.add(key)
        self._m.counter(
            'skytpu_engine_compiles_total',
            'Distinct engine dispatch shapes traced (journaled as '
            'engine.compile).').inc()
        self._journal_raw(journal.EventKind.ENGINE_COMPILE,
                          {'compile_kind': kind, **shape})

    def _journal(self, kind, request: Request, slot: int,
                 **payload) -> None:
        self._journal_raw(kind,
                          {'request': request.id, 'slot': slot, **payload},
                          trace_id=request.trace_id,
                          span_id=request.span_id)

    def _journal_raw(self, kind, payload: dict,
                     trace_id: Optional[str] = None,
                     span_id: Optional[str] = None,
                     parent_span_id: Optional[str] = None,
                     entity: Optional[str] = None) -> None:
        """Buffer one row; a per-request ``trace_id`` overrides the
        ambient trace for that row (the X-Request-Id join), and
        ``span_id``/``parent_span_id`` nest it under the HTTP span that
        carried the request (``span_id`` requires ``trace_id``)."""
        if trace_id is not None and span_id is not None:
            override = (trace_id, span_id, parent_span_id)
        else:
            override = trace_id
        self._jbuf.append(kind, entity or f'engine:{self.name}', payload,
                          override)

    def journal_buffered(self, kind, payload: dict,
                         trace_id: Optional[str] = None,
                         span_id: Optional[str] = None,
                         parent_span_id: Optional[str] = None,
                         entity: Optional[str] = None) -> None:
        """The batched journal buffer for co-located callers on the
        request hot path (the model server's span rows): they ride the
        engine tick's one transaction instead of a commit each."""
        self._journal_raw(kind, payload, trace_id=trace_id,
                          span_id=span_id, parent_span_id=parent_span_id,
                          entity=entity)

    def flush_journal(self, wait: bool = True) -> None:
        """Write the buffered rows in one transaction. ``step()`` calls
        it per tick with ``wait=False`` (a background thread writes, so a
        wedged journal disk never blocks the decode loop); ``stats()``
        and direct ``insert()`` drivers use the synchronous form."""
        self._jbuf.flush(wait=wait)

    def journal_stats(self) -> dict:
        """Journal-plane self-observability (buffered, dropped, flush
        p95)."""
        return self._jbuf.stats()
