"""Continuous-batching decode engine: slot-scheduled serving on one cache.

Counterpart of ``skypilot_tpu/models/engine.py``'s ``DecodeEngine``:
dense and paged modes, greedy and sampled decoding, radix prefix reuse,
per-tenant round-robin admission, clamp/reject of over-budget requests,
greedy speculative decoding and chunked prefill on the paged pool, the
crash supervisor, the serving telemetry, the cross-replica prefix fetch,
the disaggregated prefill/decode handoff, the durable block store's
fetch and write-behind spill, and tensor-parallel serving.

* **One persistent cache** of ``num_slots`` lanes (dense) or one block
  pool (paged), updated in place for the life of the engine.
* **insert()** prefills one request ([1, S_bucket]; prompt lengths round
  up to bucket shapes) into a free lane; the first token samples from
  the prefill logits.
* **step()** runs ``step_chunk`` single-token decode steps across every
  slot with per-slot positions, then one host fetch. The step semantics
  are exactly the reference's
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
  step profile, and the device-memory split (``engine.hbm``).
* **Compiled rounds** (``models/cuda_graphs.py``), the counterpart of
  the reference's jitted, cache-donating dispatches: on the card the
  decode round (dense and paged), the spec step and the paged prefills
  (a whole suffix or one chunk) each run as one CUDA-graph replay per
  distinct shape, from static input buffers the round fills from the
  host mirrors. The first dispatch of a shape runs eagerly (its
  ``engine.compile`` row) and is captured right after; a failed capture
  or replay raises into the supervisor. ``rounds='eager'`` runs every
  dispatch eagerly on the card through the same code (tests and
  ``chip_smoke.py`` compare the two); on the CPU the rounds always run
  eagerly. The dense insert is one replay too (``('prefill', bucket)``:
  prefill into the lane and, when greedy, the first token's argmax, the
  reference's ``_prefill_greedy_impl``; a sampled insert samples the
  replayed logits). The prefix inject/export and the copy-on-write copy
  stay eager: each is one indexed copy a plane, in place.

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

**Durable block store** (paged, ``store_url`` or ``SKYTPU_STORE_URL``;
``models/block_store.py``): the second level of the cold-miss lookup.
Whatever the local match and the peers left uncovered is asked of the
store within ``SKYTPU_STORE_FETCH_BUDGET_SECONDS`` and installed through
the peer fetch's validation and injection, so a store-warmed decode is a
local hit from then on. Each prompt's published run is spilled behind
the loop: ``step()`` copies at most one queued run to the host a step
and a worker thread POSTs it within ``SKYTPU_STORE_SPILL_BUDGET_SECONDS``.
A failed fetch or spill backs the store off for
``SKYTPU_STORE_BACKOFF_SECONDS`` (one window for both directions); a
version-skewed entry is a ``mismatch`` and does not. Outcomes are counted
in ``skytpu_store_fetches_total{result}`` and
``skytpu_store_spills_total{result}`` and journaled as
``engine.store_fetch`` and ``store.spill``.

**Tensor parallelism** (paged, ``tp > 1``; ``parallel/``): one process
a rank over ``torch.distributed``. This engine is rank 0: the scheduler,
the allocator, the radix cache and the block tables stay here, whole, as
the reference keeps paging host-global. Every rank holds its slice of
the params (``parallel/mesh``: wq/wk/wv/w1/w3 by output column, wo/w2 by
contraction row, lm_head by vocab column) and a pool of its ``Hkv / tp``
heads; the worker ranks hold an :class:`EngineShard` each and replay
every device operation this engine makes (``_device_op``: the rounds'
dispatches with their host inputs, copy-on-write, inject, export, the
first-token sample, the supervisor's reset), so each rank runs the same
kernels on its heads and the same collectives in the same order. Export
gathers every rank's heads into the unsharded payload and inject
scatters them, so prefix fetch, handoff and store keep the unsharded
engine's wire format. Sampled decoding stays in lockstep without a
broadcast: every rank samples the all-gathered logits with a generator
in the state of this engine's. A lost rank fails the engine for good
through the supervisor.

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

from skypilot_tpu_torch.models import block_store, cuda_graphs, decode
from skypilot_tpu_torch.models import llama, prefix_transfer
from skypilot_tpu_torch.observability import journal
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import request_trace
from skypilot_tpu_torch.observability import runtime_metrics
from skypilot_tpu_torch.ops import decode_attention as decode_attention_ops
from skypilot_tpu_torch.ops import quant
from skypilot_tpu_torch.parallel import mesh
from skypilot_tpu_torch.parallel import tp as tp_lib
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
# How the engine's rounds run on the card (``cuda_graphs.ROUNDS``).
ROUNDS = cuda_graphs.ROUNDS
# The pool's dim that tensor parallelism splits (the KV heads of
# ``[L, n_blocks, block_k, Hkv, hd]`` and of its scale planes).
_HEAD_DIM = mesh.kv_cache_spec().index(mesh.MODEL_AXIS)


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
    int8 weight counts its values and its scales, a tensor-parallel
    slice its own bytes)."""
    if isinstance(tree, (torch.Tensor, quant.QuantizedTensor,
                         mesh.RowParallel, mesh.VocabParallel)):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(_tree_nbytes(t) for t in tree)


def _launch_counts() -> dict:
    """This process's launch counters of the serving kernels (the decode
    and verify kernels, the int8 GEMM), by wrapper name."""
    return {fn.__name__: fn.launches
            for fn in decode_attention_ops.KERNELS +
            (quant.int8_gemm_library,)}


def check_tp(tp: int, group: Optional[tp_lib.TPGroup],
             cfg: llama.LlamaConfig, paged: bool, rounds: str) -> None:
    """The reference's TP validation, and the port's own: a given group
    must have ``tp`` ranks, and graph rounds need collectives a CUDA
    graph can capture (NCCL), never gloo's host copies."""
    if tp < 1:
        raise ValueError(f'tp must be >= 1, got {tp}')
    if tp > 1:
        # Tensor-parallel serving shards the PAGED pool by KV head, and
        # a shard must own whole GQA groups.
        if not paged:
            raise ValueError('tensor-parallel serving (tp > 1) requires '
                             'paged=True')
        if cfg.n_kv_heads % tp or cfg.n_heads % tp:
            raise ValueError(
                f'tp={tp} must divide n_kv_heads ({cfg.n_kv_heads}) and '
                f'n_heads ({cfg.n_heads})')
    if group is None:
        return
    if group.size != tp:
        raise ValueError(f'a TP group of {group.size} ranks for tp={tp}')
    if (rounds == 'graph' and group.device.type == 'cuda' and
            group.backend != 'nccl'):
        raise ValueError(f"rounds='graph' needs an nccl group: {group.path} "
                         "collectives cannot be captured in a CUDA graph "
                         "(pass rounds='eager')")


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


class EngineShard:
    """The engine's device half: the params, the pool (or dense cache),
    the rounds' static inputs and their CUDA graphs, and the operations
    that touch them (:meth:`_apply`). A :class:`DecodeEngine` is one; under
    tensor parallelism each worker rank holds one more, built by the TP
    worker loop (``parallel/tp.serve``) from the engine's ``build``
    message, and the engine sends each operation to the workers before it
    runs it on its own shard (:meth:`DecodeEngine._device_op`), so every
    rank runs the same dispatches in the same order. The host state (the
    scheduler, the allocator, the radix cache, the block tables' host
    mirror) lives on the engine only."""

    def _init_shard(self, params, cfg: llama.LlamaConfig,
                    dcfg: decode.DecodeConfig, num_slots: int,
                    step_chunk: int, paged: bool, num_blocks: int,
                    generator: torch.Generator, rounds: str,
                    group) -> None:
        self.params = params
        self.device = params['tok_embedding'].device
        self.cfg = cfg
        self.dcfg = dcfg
        self.num_slots = num_slots
        self.step_chunk = step_chunk
        self.paged = paged
        self.num_blocks = num_blocks
        self._block_k = dcfg.kernel_block_k
        self._max_blocks = dcfg.max_len // self._block_k if paged else 0
        self._group = group
        self.tp = group.size if group is not None else 1
        self._generator = generator
        # The compiled dispatches (None: every round runs eagerly) and the
        # host side of their static inputs.
        self.rounds = rounds if self.device.type == 'cuda' else 'eager'
        self._graphs: Optional[cuda_graphs.GraphCache] = (
            cuda_graphs.GraphCache(cuda_graphs.CudaCapturer(self.device,
                                                            generator))
            if self.rounds == 'graph' else None)
        self._staging = cuda_graphs.HostStaging(self.device)
        self._cache = None
        # The last dispatch's output (a worker's first-token sample reads
        # it, as the engine reads its own).
        self._last_out: Optional[torch.Tensor] = None
        self._launches_at_build = _launch_counts()

    @classmethod
    def from_message(cls, group, args: dict,
                     tensors: List[torch.Tensor]) -> 'EngineShard':
        """A worker's shard from the engine's ``build`` message: its
        param slices (``tensors``, in ``args['names']`` order; moved to
        its device, int8 values K-major), the configs and the sampling
        generator's state. The pool is made by the ``reset`` that
        follows."""
        shard = mesh.unflatten(
            [(n, t.to(group.device)) for n, t in zip(args['names'],
                                                      tensors)])
        for name, w in shard['layers'].items():
            if isinstance(w, quant.QuantizedTensor):
                shard['layers'][name] = quant.QuantizedTensor(
                    values=quant.k_major(w.values, 1), scale=w.scale)
        params = mesh.wrap_serving_params(shard, group)
        generator = torch.Generator(device=group.device)
        generator.set_state(args['generator_state'])
        self = cls.__new__(cls)
        self._init_shard(params, args['cfg'], args['dcfg'],
                         args['num_slots'], args['step_chunk'], True,
                         args['num_blocks'], generator, args['rounds'],
                         group)
        return self

    def serve_op(self, op: str, args: dict,
                 tensors: List[torch.Tensor]) -> None:
        """A worker runs one operation and replies where rank 0 waits for
        its part (``export``, ``rank_stats``)."""
        out = self._apply(op, args, tensors)
        if op == 'export':
            self._group.reply_tensors(out)
        elif op == 'rank_stats':
            self._group.reply_object(out)

    def _apply(self, op: str, args: dict, tensors: List[torch.Tensor]):
        """One device operation on this rank's shard."""
        if op == 'dispatch':
            return self._run_dispatch(args['key'], args['fills'])
        if op == 'sample_first':
            return self._sample(self._last_out)
        if op == 'copy_block':
            return decode.copy_block(self._cache, args['src'], args['dst'])
        if op == 'inject':
            return decode.inject_pool_blocks(
                self._cache, self._dev(args['ids']),
                dict(zip(sorted(self._cache), tensors)))
        if op == 'export':
            arrays = decode.export_pool_blocks(self._cache,
                                               self._dev(args['ids']))
            return [arrays[name] for name in sorted(arrays)]
        if op == 'reset':
            return self._reset_device()
        if op == 'rank_stats':
            return self._rank_stats(args.get('reset', False))
        raise ValueError(f'unknown engine operation {op!r}')

    def _reset_device(self) -> None:
        """(Re)make the pool or dense cache and the rounds' static inputs.
        The old cache is dropped before the new one is allocated (both at
        once would not fit beside the weights at full width), and the
        graphs captured over it go with it, with their pool."""
        self._cache = None
        self._last_out = None
        if self._graphs is not None:
            self._graphs.reset()
        self._staging.clear()
        num_slots = self.num_slots
        dev = self.device
        if self.paged:
            self._cache = decode.init_block_pool(
                self.cfg, self.num_blocks, self._block_k,
                self.dcfg.kv_cache_dtype, dev, self.tp)
        else:
            self._cache = decode.init_kv_cache(self.cfg, num_slots,
                                               self.dcfg.max_len,
                                               self.dcfg.kv_cache_dtype,
                                               dev)
        # The decode round's and spec step's static inputs, filled from
        # the host mirrors before each dispatch; the prefills' are made
        # per graph key (:meth:`_prefill_inputs`).
        self._round_in = {
            'token': torch.zeros((num_slots,), dtype=torch.int64,
                                 device=dev),
            'pos': torch.zeros((num_slots,), dtype=torch.int64, device=dev),
            'done': torch.ones((num_slots,), dtype=torch.bool, device=dev),
            'remaining': torch.zeros((num_slots,), dtype=torch.int64,
                                     device=dev)}
        if self.paged:
            self._round_in['tables'] = torch.zeros(
                (num_slots, self._max_blocks), dtype=torch.int32,
                device=dev)
        self._prefill_in: dict = {}

    def _run_dispatch(self, key: tuple, fills: dict) -> torch.Tensor:
        """Fill a dispatch's static inputs from host arrays (by buffer
        name) and run it (:meth:`_dispatch`): the decode round, the spec
        step, a paged prefill or a dense insert, by the key's kind."""
        kind = key[0]
        if kind == 'decode_steps':
            buf, fn = self._round_in, self._decode_body
        elif kind == 'spec_step':
            buf = self._round_in
            fn = functools.partial(self._spec_body, key[1])
        else:
            row, pref = fills.get('row'), fills.get('pref')
            buf = self._prefill_inputs(
                key, None if row is None else row.shape[0],
                None if pref is None else pref.shape[0])
            fn = functools.partial(self._prefill_body, buf)
        self._fill(buf, fills)
        self._last_out = self._dispatch(key, fn, buf.values())
        return self._last_out

    def _fill(self, buf: dict, fills: dict) -> None:
        """Copy host arrays into the static input buffers of ``buf`` that
        they name."""
        self._staging.fill([(buf[name], a) for name, a in fills.items()])

    def _prefill_inputs(self, key: tuple, n_row: Optional[int],
                        n_pref: Optional[int]) -> dict:
        """The static inputs of one prefill key, made at its first
        dispatch: tokens [1, bucket] and ``lens``, with the paged keys'
        block row and (with-prefix only) prefix blocks. ``lens`` is
        [suffix length, prefix length] paged and [prompt length, slot]
        dense."""
        buf = self._prefill_in.get(key)
        if buf is None:
            dev = self.device
            buf = {'tokens': torch.zeros((1, key[1]), dtype=torch.int64,
                                         device=dev),
                   'lens': torch.zeros((2,), dtype=torch.int64, device=dev)}
            if n_row is not None:
                buf['row'] = torch.zeros((n_row,), dtype=torch.int64,
                                         device=dev)
            if n_pref is not None:
                buf['pref'] = torch.zeros((n_pref,), dtype=torch.int64,
                                          device=dev)
            self._prefill_in[key] = buf
        return buf

    def _prefill_body(self, buf: dict) -> torch.Tensor:
        """One prefill from its static inputs (the captured body). The
        dense insert returns the first token's argmax, [1], when greedy,
        and the last logits when sampled; the paged ones the last
        logits."""
        if 'row' not in buf:
            last = decode.prefill_into_slot(
                self.params, buf['tokens'], buf['lens'][0], buf['lens'][1],
                self.cfg, self._cache)
            if self.dcfg.temperature == 0.0:
                return last.argmax()[None]
            return last
        if 'pref' not in buf:
            return decode.paged_prefill(self.params, buf['tokens'],
                                        buf['lens'][0], buf['row'],
                                        self.cfg, self._cache)
        return decode.paged_prefill_with_prefix(
            self.params, buf['tokens'], buf['lens'][0], buf['lens'][1],
            buf['pref'], buf['row'], self.cfg, self._cache)

    def _dispatch(self, key: tuple, fn: Callable[[], torch.Tensor],
                  inputs) -> torch.Tensor:
        """Run one engine dispatch: on the card its CUDA graph's replay
        (captured at the key's first dispatch, which runs eagerly), else
        ``fn()``. ``inputs`` are the static buffers ``fn`` reads; they
        and the pool must be the ones the graph was captured over."""
        if self._graphs is None:
            return fn()
        ptrs = tuple(t.data_ptr() for t in
                     itertools.chain(self._cache.values(), inputs))
        return self._graphs.run(key, fn, ptrs)

    def graph_stats(self) -> dict:
        """The compiled rounds: ``rounds`` ('graph' or 'eager'), and on
        the graph path the graphs held, captures by kind since start
        (restarts capture again), their seconds, replays and the pool's
        reserved and allocated bytes."""
        if self._graphs is None:
            return {'rounds': self.rounds}
        return {'rounds': self.rounds, **self._graphs.stats()}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _sample(self, last_logits: torch.Tensor) -> int:
        return int(decode.sample(last_logits[None], self._generator,
                                 self.dcfg.temperature)[0])

    def _rank_stats(self, reset: bool) -> dict:
        """This rank's pool shapes, the decode-attention and int8-GEMM
        launches its process counted since this shard was built, and its
        peak device bytes (``reset``: start the peak again after
        reading)."""
        now = _launch_counts()
        out = {'rank': self._group.rank if self._group else 0,
               'pool_shapes': {name: tuple(t.shape)
                               for name, t in self._cache.items()},
               'launches': {name: n - self._launches_at_build[name]
                            for name, n in now.items()},
               'max_memory_allocated': (
                   torch.cuda.max_memory_allocated(self.device)
                   if self.device.type == 'cuda' else 0)}
        if reset and self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        return out

    def _decode_body(self) -> torch.Tensor:
        """The decode round from its static inputs (the captured body):
        [step_chunk x num_slots tokens, then token, pos, done,
        remaining], the one tensor the host fetches."""
        eos = self.dcfg.eos_id
        b = self._round_in
        token, pos, done, remaining = (b['token'], b['pos'], b['done'],
                                       b['remaining'])
        tables = b['tables'] if self.paged else None
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
        return torch.cat([torch.stack(toks).flatten(), token, pos,
                          done.long(), remaining])

    def _spec_body(self, nb_bucket: int) -> torch.Tensor:
        """One spec step from the round's static inputs (the captured
        body, one per drafter block bucket): the drafter reads the
        tables' first ``nb_bucket`` columns, the verify all of them.
        Returns [drafts | verify argmax], [B, 2 * spec_k + 1]."""
        b = self._round_in
        drafts, vtok = _spec_step(self.params, b['token'], b['pos'],
                                  b['tables'][:, :nb_bucket], b['tables'],
                                  self._cache, self.cfg, self.dcfg)
        return torch.cat([drafts, vtok], dim=1)


class DecodeEngine(EngineShard):
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
    calls.

    ``store_url`` (default ``SKYTPU_STORE_URL``; kept only when paged) is
    the durable block store a cold miss asks after the peers and a
    published run spills to. ``store_fetch_fn(url, tokens, from_tokens,
    budget)`` and ``store_spill_fn(url, tokens, payload, budget)`` are its
    transports (default: ``block_store.http_store_fetch`` carrying
    ``instance_id`` and ``block_store.http_store_spill``).

    ``rounds`` (one of :data:`ROUNDS`): on a CUDA device the decode
    rounds, spec steps, prefills and dense inserts replay CUDA graphs
    (``'graph'``, the default) or run eagerly (``'eager'``); on the CPU
    they run eagerly either way. The reference has no such switch, so
    neither the CLI nor the environment sets it.

    ``tp`` > 1 (paged only; it must divide both head counts) serves
    tensor-parallel over ``tp_group`` (``parallel/tp.TPGroup`` of ``tp``
    ranks, this process its rank 0; ``serve/model_server.build_engine``
    makes one). :meth:`close` ends the group only when ``own_group``
    hands it to the engine. A group whose collectives copy through the
    host (gloo on cards) refuses ``rounds='graph'``."""

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
                 store_url: Optional[str] = None,
                 store_fetch_fn: Optional[Callable] = None,
                 store_spill_fn: Optional[Callable] = None,
                 journal_db: Optional[str] = None,
                 rounds: str = 'graph', tp: int = 1,
                 tp_group: Optional[tp_lib.TPGroup] = None,
                 own_group: bool = False):
        if num_slots < 1:
            raise ValueError(f'num_slots must be >= 1, got {num_slots}')
        if step_chunk < 1:
            raise ValueError(f'step_chunk must be >= 1, got {step_chunk}')
        if rounds not in ROUNDS:
            raise ValueError(f'rounds must be one of {ROUNDS}, got '
                             f'{rounds!r}')
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
        check_tp(tp, tp_group, cfg, paged, rounds)
        if tp > 1 and tp_group is None:
            raise ValueError(f'tp={tp} needs a TP group (tp_group; '
                             'build_engine makes one)')
        self.name = name
        bk = dcfg.kernel_block_k
        self._buckets = (tuple(sorted(int(b) for b in prefill_buckets))
                         if prefill_buckets
                         else _default_buckets(dcfg.max_len))
        if self._buckets[-1] > dcfg.max_len:
            raise ValueError(f'prefill buckets {self._buckets} exceed '
                             f'max_len {dcfg.max_len}')
        if paged:
            if dcfg.max_len % bk:
                raise ValueError(
                    f'paged mode needs max_len ({dcfg.max_len}) '
                    f'divisible by block_k ({bk})')
            # Prefill writes whole blocks: snap buckets to block
            # multiples.
            self._buckets = tuple(sorted({
                min(-(-b // bk) * bk, dcfg.max_len)
                for b in self._buckets}))
            # Default pool: the dense cache's token capacity + scratch.
            if num_blocks is None:
                num_blocks = num_slots * (dcfg.max_len // bk) + 1
        else:
            num_blocks = 0
        # Tensor parallelism: this process is rank 0 of the group, holds
        # its own slice of the params and the pool, and sends the workers
        # theirs in the ``build`` message.
        self._owns_group = own_group
        device = (tp_group.device if tp_group is not None
                  else params['tok_embedding'].device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        if tp_group is not None:
            params = self._build_workers(params, tp_group, cfg, dcfg,
                                         num_slots, step_chunk, num_blocks,
                                         generator, rounds)
        self._init_shard(params, cfg, dcfg, num_slots, step_chunk, paged,
                         num_blocks, generator, rounds, tp_group)
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
        # Durable block-store tier (paged only): the second level of the
        # cold-miss lookup and the write-behind spill target of published
        # runs. Fetch and spill share one backoff, so a dead store costs
        # at most one budget a window across both.
        if store_url is None:
            store_url = os.environ.get(block_store.STORE_URL_ENV,
                                       '').strip() or None
        self.store_url: Optional[str] = store_url if paged else None
        self._store_fetch_fn = (
            store_fetch_fn if store_fetch_fn is not None
            else functools.partial(block_store.http_store_fetch,
                                   instance=self.instance_id))
        self._store_spill_fn = (store_spill_fn if store_spill_fn is not None
                                else block_store.http_store_spill)
        self._store_fetch_budget = env.env_float(
            block_store.FETCH_BUDGET_ENV,
            block_store.DEFAULT_FETCH_BUDGET_SECONDS)
        self._store_spill_budget = env.env_float(
            block_store.SPILL_BUDGET_ENV,
            block_store.DEFAULT_SPILL_BUDGET_SECONDS)
        self._store_backoff = env.env_float(
            block_store.BACKOFF_ENV, block_store.DEFAULT_BACKOFF_SECONDS)
        self._store_backoff_until = 0.0
        self._store_spill_min_tokens = env.env_int(
            block_store.SPILL_MIN_TOKENS_ENV, 0) or self._block_k
        # Write-behind spill state (loop thread only): published runs
        # queue here; one host copy and one POST in flight at a time, so
        # a spill costs the loop at most one block export a step and the
        # wire time rides the worker thread. The executor is made at the
        # first spill and shut down when the loop ends.
        self._spill_pending: List[List[int]] = []
        self._spill_inflight: Optional[Tuple] = None
        self._spill_seen: set = set()
        self._spill_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._store_fetch_hits = 0
        self._store_fetch_misses = 0
        self._store_fetch_tokens = 0
        self._store_spills = 0
        self._store_spill_tokens = 0
        self._store_spill_failures = 0
        self._store_spill_drops = 0
        # Peers' /prefix_blocks exports and /handoff_blocks injections
        # queue here from any thread and are served by the loop at the top
        # of each step (the radix cache and the pool are loop-confined).
        self._export_lock = threading.Lock()
        self._export_jobs: List[dict] = []
        # engine.compile dedupe: dispatch shapes already noted. Restarts
        # keep it, as the reference's process-global jit cache does.
        self._traced_shapes: set = set()
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
        # The serving group's topology: one rank (the unsharded engine)
        # or one process a rank.
        devices = (self._group.devices if self._group is not None
                   else [self.device])
        self._m.gauge(
            'skytpu_engine_tp_degree',
            'Tensor-parallel degree of the serving mesh (1 = '
            'unsharded).').set(self.tp)
        self._m.gauge(
            'skytpu_engine_mesh_devices',
            'Devices in the engine serving mesh.').set(len(devices))
        cuda = self.device.type == 'cuda'
        # engine.mesh and engine.hbm: journaled once at engine start (the
        # supervisor's rebuild makes an identically sized cache). The
        # reference counts processes of its runtime (1 on one host); here
        # each rank is a process.
        self._journal_raw(journal.EventKind.ENGINE_MESH, {
            'tp': self.tp,
            'mesh_shape': {'model': self.tp},
            'devices': len(devices),
            'device_kinds': sorted({torch.cuda.get_device_name(d)
                                    if d.type == 'cuda' else 'cpu'
                                    for d in devices}),
            'platform': 'gpu' if cuda else 'cpu',
            'process_count': self.tp,
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
        self._journal_raw(journal.EventKind.ENGINE_HBM,
                          {'tp': self.tp, **hbm})
        self.flush_journal()

    def _hbm_accounting(self) -> dict:
        """Device byte split of this engine's footprint. Weights and the
        pool (or dense cache) are exact byte sums of their tensors;
        workspace is the rest of ``torch.cuda.memory_allocated`` on the
        card plus the CUDA graphs' pool, whole (``workspace_measured:
        true``), and 0 on the CPU, which has no device memory to meter
        (``workspace_measured: false``). The ``engine.hbm`` row is taken
        at engine start, before any capture."""
        weights = _tree_nbytes(self.params)
        pool = _tree_nbytes(self._cache)
        pool_kind = 'paged_pool' if self.paged else 'kv_cache'
        workspace = 0
        measured = self.device.type == 'cuda'
        if measured:
            # The CUDA graphs' pool is workspace, whole: its reserved
            # bytes, live or not, in place of its allocated ones.
            reserved, allocated = ((0, 0) if self._graphs is None
                                   else self._graphs.pool_bytes())
            workspace = max(0, torch.cuda.memory_allocated(self.device)
                            - weights - pool - allocated) + reserved
        return {
            'per_device_bytes': {'weights': weights,
                                 pool_kind: pool,
                                 'workspace': workspace},
            'workspace_measured': measured,
            'pool_kind': pool_kind,
        }

    def _init_runtime_state(self) -> None:
        """(Re)build what a crashed step may have left inconsistent: the
        device cache/pool on every rank (:meth:`_reset_device`), the
        allocator + radix cache, block tables and the per-slot host
        mirrors. Called at construction and by the supervisor's restart;
        the queues and cumulative stats stay, so queued requests
        re-prefill against the fresh cache."""
        num_slots = self.num_slots
        self._device_op('reset')
        if self.paged:
            self._allocator = BlockAllocator(self.num_blocks)
            self._radix = RadixPrefixCache(self._block_k, self._allocator)
            # Rows of free slots point at SCRATCH_BLOCK; the device copy
            # (the rounds' static ``tables``) is refilled only after
            # admission/eviction changes it.
            self._block_table_np = np.zeros(
                (num_slots, self._max_blocks), np.int32)
            self._tables_dirty = True
            self._slot_refs: List[List[int]] = [[] for _ in
                                                range(num_slots)]
            self._slot_nodes: List[list] = [[] for _ in range(num_slots)]
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

    # ------------------------------------------------ tensor parallelism

    def _build_workers(self, params, group: 'tp_lib.TPGroup',
                       cfg: llama.LlamaConfig, dcfg: decode.DecodeConfig,
                       num_slots: int, step_chunk: int, num_blocks: int,
                       generator: torch.Generator, rounds: str):
        """Send every worker of ``group`` its param slices, the configs
        and the sampler's state (``build``), and return rank 0's own
        slices. A worker's slices are cut on the host one worker at a
        time, so the host holds at most one worker's share."""
        specs = mesh.serving_param_specs(cfg)
        local = mesh.shard_serving_params(params, specs, 0, group.size,
                                          group.device)

        def worker_slices(rank):
            return [t for _, t in mesh.flatten(mesh.shard_serving_params(
                params, specs, rank, group.size, 'cpu'))]

        with group.lock:
            # The workers now serve this engine; another engine's
            # operations on the group raise.
            group.owner = self
            group.post('build', {
                'names': [n for n, _ in mesh.flatten(local)],
                'cfg': cfg, 'dcfg': dcfg,
                'num_slots': num_slots, 'step_chunk': step_chunk,
                'num_blocks': num_blocks, 'rounds': rounds,
                'generator_state': generator.get_state()},
                {r: functools.partial(worker_slices, r)
                 for r in range(1, group.size)})
        return mesh.wrap_serving_params(local, group)

    def _device_op(self, op: str, tensors=None, **args):
        """Run one device operation (:meth:`EngineShard._apply`) on every
        rank: the workers get it first (``tensors``: rank -> that rank's
        tensors, rank 0's included), then this rank runs it. Without a
        group it just runs here."""
        tensors = tensors or {}
        group = self._group
        if group is None:
            return self._apply(op, args, tensors.get(0, []))
        with group.lock:
            if group.owner is not self:
                raise RuntimeError(f'the TP group serves another engine; '
                                   f'{self.name} was closed or replaced')
            group.post(op, args, {r: t for r, t in tensors.items() if r})
            return self._apply(op, args, tensors.get(0, []))

    def _head_slices(self, arrays: dict) -> dict:
        """Unsharded pool planes ``[L, n, block_k, Hkv, ...]`` → each
        rank's list of its ``Hkv / tp`` heads (sorted plane names)."""
        out = {}
        for r in range(self.tp):
            out[r] = []
            for name in sorted(arrays):
                a = arrays[name]
                start, stop = mesh.split_range(a.shape[_HEAD_DIM], r,
                                               self.tp)
                out[r].append(a.narrow(_HEAD_DIM, start, stop - start))
        return out

    def _pool_shape(self, name: str) -> Tuple[int, ...]:
        """The unsharded shape of one pool plane: what export payloads
        carry and injection takes, whatever the TP degree."""
        shape = list(self._cache[name].shape)
        shape[_HEAD_DIM] *= self.tp
        return tuple(shape)

    def _export_blocks(self, blocks: Sequence[int]) -> dict:
        """Pool blocks ``blocks`` of every plane copied to the host,
        ``[L, n, block_k, Hkv, ...]``: under TP each rank exports its
        heads and rank 0 joins them, so the payload's bytes are the
        unsharded engine's."""
        ids = np.asarray(blocks, np.int64)
        names = sorted(self._cache)
        group = self._group
        if group is None:
            return dict(zip(names, self._apply('export', {'ids': ids}, [])))
        with group.lock:
            local = self._device_op('export', ids=ids)
            parts = group.collect_tensors(local)
        return {name: torch.cat([local[i]] + [p[i] for p in parts],
                                dim=_HEAD_DIM)
                for i, name in enumerate(names)}

    def rank_stats(self, reset: bool = False) -> List[dict]:
        """Each rank's pool shapes, the decode-attention and int8-GEMM
        launches its process counted since this engine was built (on rank
        0 other engines of the process count too), and its peak device
        bytes, rank 0 first (``reset``: start the peaks again after
        reading). One entry without tensor parallelism."""
        group = self._group
        if group is None:
            return [self._rank_stats(reset)]
        with group.lock:
            own = self._device_op('rank_stats', reset=reset)
            return group.collect_objects(own)

    def close(self) -> None:
        """Free the workers' shards (the group can build another engine)
        and close the group if it was handed over (``own_group``).
        Idempotent; a no-op
        without tensor parallelism."""
        group = self._group
        if group is None:
            return
        if group.owner is self:
            group.owner = None
            if group.alive():
                try:
                    group.post('close')
                except Exception:  # pylint: disable=broad-except
                    pass
        if self._owns_group:
            group.close()

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
            out = self._device_op(
                'dispatch', key=('prefill', bucket),
                fills={'tokens': padded,
                       'lens': np.asarray([p, slot], np.int64)})
            first = (int(out[0]) if self.dcfg.temperature == 0.0 else
                     self._sample_first(out))
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
        # The second level of the cold-miss lookup: what the peers (or no
        # peers) left uncovered, the durable store may hold, so a cold
        # start or a scale-up warms from disk. The same match-again
        # contract as the peer fetch's.
        if self._should_store_fetch(p, m_full):
            if self._store_fetch_into_cache(request, blocks, m_full):
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
                self._device_op('copy_block', src=cow_src, dst=cow_dst)
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
        self._tables_dirty = True
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
            shape = self._pool_shape(name)
            want = (shape[0], n_new) + shape[2:]
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
            self._device_op('inject', self._head_slices(arrays),
                            ids=np.asarray(new_blocks, np.int64))
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

    # ------------------------------------------- durable block-store tier

    def _should_store_fetch(self, p: int, m_full: int) -> bool:
        """The second-level lookup's gate: a store is configured and out
        of backoff, and the miss left after the local match and any peer
        fetch still holds the minimum block-aligned gain."""
        if not self.paged or not self.store_url:
            return False
        if self._store_backoff_until > time.perf_counter():
            return False
        aligned = (p // self._block_k) * self._block_k
        return aligned - m_full >= max(self._prefix_fetch_min_tokens,
                                       self._block_k)

    def _note_store_failure(self) -> None:
        self._store_backoff_until = (time.perf_counter() +
                                     self._store_backoff)

    def store_in_backoff(self) -> bool:
        """Is the durable store inside its failure-backoff window (shown
        on /slo)?"""
        return self._store_backoff_until > time.perf_counter()

    def _store_fetch_into_cache(self, request: Request,
                                local_blocks: List[int],
                                m_full: int) -> bool:
        """Pull the prompt's missing prefix blocks from the durable store
        and install them through :meth:`_install_remote_blocks`, the peer
        fetch's validation and injection; True when the cache now holds a
        longer prefix. Every failure degrades to plain prefill; a
        transport failure, a raise or a failed install back the store
        off, a version-skewed entry (``mismatch``) does not."""
        bk = self._block_k
        aligned = (len(request.prompt) // bk) * bk
        t0 = time.perf_counter()
        outcome = 'miss'
        gained = 0
        try:
            payload = self._store_fetch_fn(
                self.store_url, request.prompt[:aligned], m_full,
                self._store_fetch_budget)
        except Exception as e:  # pylint: disable=broad-except
            payload = None
            self._note_store_failure()
            outcome = 'error'
            self._journal(journal.EventKind.ENGINE_STORE_FETCH, request, -1,
                          outcome='error', store=self.store_url,
                          error=f'{type(e).__name__}: {e}')
        if outcome != 'error':
            if payload is None:
                # Down, timed out or garbage: one dead store must not cost
                # every cold admission a budget of loop stall.
                self._note_store_failure()
                outcome = 'down'
            elif payload.get('self'):
                # The store URL addresses this replica: no store at all.
                self.store_url = None
            else:
                try:
                    gained = self._install_remote_blocks(
                        request.prompt, payload, local_blocks, m_full)
                except Exception as e:  # pylint: disable=broad-except
                    self._note_store_failure()
                    gained = 0
                    outcome = 'error'
                    self._journal(journal.EventKind.ENGINE_STORE_FETCH,
                                  request, -1, outcome='error',
                                  store=self.store_url,
                                  error=f'{type(e).__name__}: {e}')
                else:
                    if gained is None:
                        outcome = 'mismatch'
                    elif gained == 'pool_exhausted':
                        outcome = 'pool_exhausted'
                    elif gained != 'empty':
                        outcome = 'hit'
        hit = outcome == 'hit'
        if hit:
            self._store_fetch_hits += 1
            self._store_fetch_tokens += gained
        else:
            self._store_fetch_misses += 1
        self._m.counter(
            'skytpu_store_fetches_total',
            'Durable-store prefix-block fetch attempts by outcome.',
            labels=('result',)).inc(labels=(outcome,))
        if outcome != 'error':
            # (an error is journaled above, with the exception's text)
            extra = ({'tokens_gained': gained, 'blocks_gained': gained // bk}
                     if hit else {})
            self._journal(journal.EventKind.ENGINE_STORE_FETCH, request, -1,
                          outcome=outcome, store=self.store_url,
                          seconds=round(time.perf_counter() - t0, 6),
                          **extra)
        return hit

    def _queue_store_spill(self, tokens: Sequence[int]) -> None:
        """LOOP THREAD ONLY: queue one newly published radix run for the
        write-behind spill. Deduplicated (a shared system prompt publishes
        on every admission that extends it: one spill per distinct run)
        and bounded (the 16 newest runs; older ones are dropped and
        counted)."""
        if not (self.paged and self.store_url
                and self._store_spill_fn is not None):
            return
        tokens = [int(t) for t in tokens]
        if len(tokens) < max(self._store_spill_min_tokens, self._block_k):
            return
        key = (len(tokens), hash(tuple(tokens)))
        if key in self._spill_seen:
            return
        if len(self._spill_seen) > 4096:
            self._spill_seen.clear()
        self._spill_seen.add(key)
        self._spill_pending.append(tokens)
        if len(self._spill_pending) > 16:
            self._spill_pending.pop(0)
            self._store_spill_drops += 1

    def _spill_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._spill_pool is None:
            self._spill_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f'{self.name}-spill')
        return self._spill_pool

    def _shutdown_spill_executor(self) -> None:
        """Stop the spill thread (loop end). A POST already on the wire
        runs out its own budget; it holds only a host copy and the
        transport."""
        pool, self._spill_pool = self._spill_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def _count_store_spill(self, tokens: List[int], ok: bool) -> None:
        result = 'ok' if ok else 'failed'
        if ok:
            self._store_spills += 1
            self._store_spill_tokens += len(tokens)
        else:
            self._store_spill_failures += 1
            # The run stays in the radix cache and an extension publishes
            # it again; retrying here would hammer a dead store.
            self._note_store_failure()
        self._m.counter(
            'skytpu_store_spills_total',
            'Write-behind spills to the durable store by outcome.',
            labels=('result',)).inc(labels=(result,))
        self._journal_raw(journal.EventKind.STORE_SPILL,
                          {'outcome': result, 'tokens': len(tokens),
                           'store': self.store_url})

    def _service_store_spills(self) -> None:
        """LOOP THREAD ONLY (top of ``step()``): resolve the last spill
        POST, then start at most one new one. The loop pays one radix
        match and one host copy of the run's blocks; the worker thread
        gets that copy, never a view of the pool the next step may
        overwrite. A failed POST backs the store off."""
        if self._spill_inflight is not None:
            fut, tokens = self._spill_inflight
            if not fut.done():
                return
            self._spill_inflight = None
            try:
                ok = bool(fut.result())
            except Exception:  # pylint: disable=broad-except
                ok = False
            self._count_store_spill(tokens, ok)
        if (not self._spill_pending or not self.store_url
                or self._store_backoff_until > time.perf_counter()):
            return
        tokens = self._spill_pending.pop(0)
        raw = self._export_prefix_now(tokens, 0)
        if raw is None:
            # Evicted between the publish and the spill: nothing to keep.
            return
        fut = self._spill_executor().submit(
            self._store_spill_fn, self.store_url, tokens, raw,
            self._store_spill_budget)
        self._spill_inflight = (fut, tokens)

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
        (a partial tail block and a copy-on-write clone stay private),
        then queue the published run for the store's write-behind spill."""
        self._count_prompt(prompt, m)
        full = len(prompt) // self._block_k
        if full:
            self._radix.insert(prompt[:full * self._block_k], table[:full])
            self._queue_store_spill(prompt[:full * self._block_k])

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
        the ``engine.compile`` shape then carries; the graph's key
        leaves it out, so a chunk and a whole suffix of one shape share
        a graph). The bucket's padding writes past ``end`` into the
        request's own blocks (or scratch); nothing attends there before
        the next chunk or decode step overwrites it. The lengths travel
        as 0-d tensors of the key's static buffers, so one graph serves
        every length of its bucket."""
        bk = self._block_k
        suf = end - start
        bucket = self._bucket_for(suf)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :suf] = prompt[start:end]
        chunk_shape = {'chunk': chunk} if chunk else {}
        if start == 0:
            self._note_compile('paged_prefill', bucket=bucket,
                               **chunk_shape)
            key = ('paged_prefill', bucket)
            row = np.full((bucket // bk,), SCRATCH_BLOCK, np.int64)
            nrow = min(len(table), len(row))
            row[:nrow] = table[:nrow]
            pref = None
        else:
            # Prefix block count buckets to powers of two (the
            # reference's compile bound; padding rows point at scratch
            # and are masked by prefix_len).
            npb = -(-start // bk)
            npb_bucket = 1
            while npb_bucket < npb:
                npb_bucket *= 2
            self._note_compile('paged_prefill_with_prefix', bucket=bucket,
                               npb_bucket=npb_bucket, **chunk_shape)
            key = ('paged_prefill_with_prefix', bucket, npb_bucket)
            pref = np.full((npb_bucket,), SCRATCH_BLOCK, np.int64)
            pref[:npb] = table[:npb]
            # Writes start inside block start // bk at offset start % bk,
            # so the row holds one block more than the bucket.
            srow = start // bk
            row = np.full((bucket // bk + 1,), SCRATCH_BLOCK, np.int64)
            avail = table[srow:srow + len(row)]
            row[:len(avail)] = avail
        fills = {'tokens': padded, 'row': row,
                 'lens': np.asarray([suf, start], np.int64)}
        if pref is not None:
            fills['pref'] = pref
        return self._device_op('dispatch', key=key, fills=fills)

    def _bucket_for(self, n: int) -> int:
        """Smallest prefill bucket covering ``n`` tokens (ValueError —
        a journaled reject, not a dead loop — when none does)."""
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(f'no prefill bucket >= {n} '
                         f'(buckets: {self._buckets})')

    def _sample_first(self, last_logits: torch.Tensor) -> int:
        """The first token from a prefill's last logits. Every rank
        samples its own copy of the (gathered) logits with a generator in
        lockstep with this one, so a sampled engine's ranks agree on
        every token without a broadcast."""
        if self._group is not None:
            self._group.post('sample_first')
        return self._sample(last_logits)

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
        arrays = self._export_blocks(send)
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
        self._tables_dirty = True
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
        # published last step is exportable at once; then the store's
        # write-behind spill: harvest the last POST, start at most one.
        self._service_prefix_exports()
        self._service_store_spills()
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

    def _round_fills(self) -> dict:
        """The host mirrors (and the block tables, when an admission or
        eviction changed them) that a round copies into its static
        inputs, by buffer name."""
        fills = {'token': self._token, 'pos': self._pos, 'done': self._done,
                 'remaining': self._remaining}
        if self.paged and self._tables_dirty:
            fills['tables'] = self._block_table_np
            self._tables_dirty = False
        return fills

    def _decode_round(self) -> int:
        """``step_chunk`` single-token steps over every slot, then one
        host fetch and delivery; returns the steps run. Per-step
        semantics are the reference's ``_scan_engine_steps``: sample →
        EOS-force → done-fold, one budget unit per live step, done lanes
        freeze their position. One dispatch (:meth:`_decode_body`) per
        ``(paged, step_chunk)``: the reference's ``_engine_steps_impl``
        and ``_engine_paged_steps_impl``."""
        self._note_compile('decode_steps', n_steps=self.step_chunk,
                           paged=self.paged)
        out = self._device_op('dispatch',
                              key=('decode_steps', self.step_chunk,
                                   self.paged),
                              fills=self._round_fills())
        # One fused host fetch (the step's only sync point).
        host = out.cpu().numpy()
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
        out = self._device_op('dispatch', key=('spec_step', nb_bucket),
                              fills=self._round_fills())
        # One host fetch per round.
        host = out.cpu().numpy()
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
            self._tables_dirty = True
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
            # The pushes' and the spills' threads must not outlive the
            # loop that owns them.
            self._shutdown_handoff_executor()
            self._shutdown_spill_executor()

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
        # A tensor-parallel rank that is gone takes its shard with it:
        # nothing here can rebuild the replica, so the failure is final.
        rank_lost = self._group is not None and not self._group.alive()
        exc_text = str(exc) or type(exc).__name__
        self._journal_raw(journal.EventKind.ENGINE_CRASH, {
            'error': exc_text,
            'traceback': ''.join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            'in_flight': self.active_slots(),
            'queued': self.queue_depth(),
            'crashes_in_window': len(self._crash_times),
            'max_restarts': budget,
            'permanent': permanent or rank_lost,
        })
        self._fail_in_flight(f'error: engine crashed: {exc_text}')
        if not (permanent or rank_lost):
            # The traceback's frames may hold the old cache (a crash
            # inside a decode call): clear them so the rebuild can reuse
            # its memory.
            traceback.clear_frames(exc.__traceback__)
            # A push still in flight belongs to a failed request: its
            # state goes with the old pool, and its thread holds only a
            # snapshot.
            self._shutdown_handoff_executor()
            try:
                self._init_runtime_state()
            except Exception as rebuild_exc:  # pylint: disable=broad-except
                if self._group is None:
                    raise
                # Under TP the rebuild reaches every rank: one that fails
                # it is lost.
                rank_lost = True
                exc_text = f'rebuild failed: {rebuild_exc}'
        if permanent or rank_lost:
            self.failed = True
            self.fail_reason = (
                f'a tensor-parallel rank is lost; last: {exc_text}'
                if rank_lost else
                f'{len(self._crash_times)} crashes within {window:.0f}s '
                f'(budget {budget}); last: {exc_text}')
            self._fail_queued()
            self.flush_journal()
            return False
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
        counters, the peer tier's and the store tier's (loop-owned ints,
        read stale by a tick at worst)."""
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
            'store_configured': bool(self.store_url),
            'store_in_backoff': (self.store_in_backoff()
                                 if self.store_url else False),
            'store_fetch_hits': self._store_fetch_hits,
            'store_fetch_misses': self._store_fetch_misses,
            'store_fetch_tokens': self._store_fetch_tokens,
            'store_spills': self._store_spills,
            'store_spill_tokens': self._store_spill_tokens,
            'store_spill_failures': self._store_spill_failures,
            'store_spill_drops': self._store_spill_drops,
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
            'tp': self.tp,
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
                'store_configured': bool(self.store_url),
                'store_fetch_hits': self._store_fetch_hits,
                'store_spills': self._store_spills,
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
        keys. The row marks the dispatch that runs a shape eagerly for
        the first time; for a compiled kind (``decode_steps``,
        ``spec_step``, ``paged_prefill``, ``paged_prefill_with_prefix``)
        on the card its CUDA graph is captured right after it
        (:meth:`_dispatch`), the counterpart of the reference's trace.
        The dedupe set survives supervisor restarts, as the reference's
        process-global jit cache does; the graphs do not, so a rebuilt
        engine captures again without a second row."""
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
