"""Durable fleet KV cache: a disk-backed persistent prefix-block store.

Counterpart of ``skypilot_tpu/models/block_store.py``. The cross-replica
prefix fetch and the handoff make every replica's radix cache one fleet
cache, but it all dies with the fleet: a cold start, a scale-up or a full
restart prefills every shared prefix again. This module is the durable
tier behind it: a store process (a model server with ``--role store`` or
an explicit ``store=``) persists published radix runs to disk and serves
them back over the same ``POST /prefix_blocks`` protocol a peer replica
speaks, so the engine's cold-miss path needs no second wire format: peer
first, store second, plain prefill last.

* **The wire format, byte for byte.** An entry is the
  :mod:`prefix_transfer` payload (bf16 bytes; int8 values plus their
  fp32 scale planes; ``[L, n, block_k, ...]`` blocks) plus the run's
  ``prompt``, written as ``<root>/<family>/<digest>.json`` with the
  reference's keys and ``json.dumps`` defaults, so a directory written by
  either package loads in the other. Decoded payload arrays are CPU
  tensors (``prefix_transfer.decode_payload``): the store never puts K/V
  on the card.
* **Torn-write safe.** A spill writes ``<digest>.json.tmp-*`` and then
  ``os.replace``: a crash mid-spill leaves the old entry or a tmp file
  (swept at load), never a half-written visible entry. An entry that
  fails to parse (a legacy crash, disk corruption, the
  ``store_torn_entry`` chaos point) is dropped and unlinked: a torn entry
  is a miss, never garbage K/V.
* **Capacity-bounded.** ``SKYTPU_STORE_CAPACITY_BYTES`` caps the bytes on
  disk with LRU eviction over digest families (entries sharing their
  first ``SKYTPU_STORE_FAMILY_TOKENS`` tokens evict together).
* **Write-behind spill.** Replicas persist newly published runs from a
  background worker (``DecodeEngine._service_store_spills``), within
  ``SKYTPU_STORE_SPILL_BUDGET_SECONDS``; a failed spill or fetch backs
  the store off for ``SKYTPU_STORE_BACKOFF_SECONDS``. A dead or slow store
  degrades both to "no store": never a stall, never a 500.

The transports are the standard library's ``http.client``, because the
card host has no ``requests``. Chaos points (``utils/chaos.py``):
``store_down`` fails the three client transports before any bytes move,
``store_torn_entry`` makes :meth:`BlockStore.put` persist half an entry
at the final path, ``store_slow`` makes :meth:`BlockStore.get` sleep
``SKYTPU_CHAOS_STORE_SLOW_SECONDS`` first.
"""
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.models import prefix_transfer
from skypilot_tpu_torch.utils import chaos, env

# Where replicas fetch from and spill to (the store's base URL; unset: no
# durable tier).
STORE_URL_ENV = 'SKYTPU_STORE_URL'
# Arms the store role on a model server: the directory entries live under.
STORE_DIR_ENV = 'SKYTPU_STORE_DIR'
CAPACITY_ENV = 'SKYTPU_STORE_CAPACITY_BYTES'
DEFAULT_CAPACITY_BYTES = 1 << 30
# Cold-miss store lookups ride the engine loop as peer fetches do, with
# their own budget.
FETCH_BUDGET_ENV = 'SKYTPU_STORE_FETCH_BUDGET_SECONDS'
DEFAULT_FETCH_BUDGET_SECONDS = 0.5
# One write-behind spill POST's budget (off the loop: it bounds the
# worker, not the engine step).
SPILL_BUDGET_ENV = 'SKYTPU_STORE_SPILL_BUDGET_SECONDS'
DEFAULT_SPILL_BUDGET_SECONDS = 2.0
# A store that failed (fetch or spill) is left alone this long.
BACKOFF_ENV = 'SKYTPU_STORE_BACKOFF_SECONDS'
DEFAULT_BACKOFF_SECONDS = 30.0
# Only runs at least this many tokens long are spilled (0: the engine's
# block size).
SPILL_MIN_TOKENS_ENV = 'SKYTPU_STORE_SPILL_MIN_TOKENS'
# Digest families: entries sharing their first N tokens (or their whole
# prompt when shorter) evict together and are warmed together.
FAMILY_TOKENS_ENV = 'SKYTPU_STORE_FAMILY_TOKENS'
DEFAULT_FAMILY_TOKENS = 128
# Chaos: how long a fired ``store_slow`` wedges one lookup.
STORE_SLOW_SECONDS_ENV = chaos.STORE_SLOW_SECONDS_ENV
DEFAULT_STORE_SLOW_SECONDS = chaos.DEFAULT_STORE_SLOW_SECONDS


def family_digest(tokens: Sequence[int],
                  family_tokens: Optional[int] = None) -> str:
    """The digest-family key of a token run: sha1 over the first
    ``family_tokens`` token ids as decimal text, each followed by a
    comma (the load balancer's prefix-digest encoding), 16 hex digits."""
    if family_tokens is None:
        family_tokens = env.env_int(FAMILY_TOKENS_ENV, DEFAULT_FAMILY_TOKENS)
    h = hashlib.sha1()
    for t in tokens[:max(int(family_tokens), 1)]:
        h.update(b'%d,' % int(t))
    return h.hexdigest()[:16]


def _entry_digest(tokens: Sequence[int]) -> str:
    """Entry key: sha1 over the whole block-aligned run, in the family
    digest's encoding."""
    h = hashlib.sha1()
    for t in tokens:
        h.update(b'%d,' % int(t))
    return h.hexdigest()


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class _Entry:
    __slots__ = ('tokens', 'family', 'path', 'nbytes', 'block_k',
                 'kv_cache_dtype')

    def __init__(self, tokens: Tuple[int, ...], family: str, path: str,
                 nbytes: int, block_k: int, kv_cache_dtype: str):
        self.tokens = tokens
        self.family = family
        self.path = path
        self.nbytes = nbytes
        self.block_k = block_k
        self.kv_cache_dtype = kv_cache_dtype


class BlockStore:
    """Disk-backed prefix-block store (one directory, one process).

    Thread-safe: the store role's HTTP handlers call ``get``/``put`` from
    server threads. The in-memory index holds metadata only (tokens,
    sizes); the arrays stay on disk until a fetch reads them."""

    def __init__(self, root: str, capacity_bytes: Optional[int] = None,
                 family_tokens: Optional[int] = None):
        self.root = root
        self.capacity_bytes = (
            capacity_bytes if capacity_bytes is not None
            else env.env_int(CAPACITY_ENV, DEFAULT_CAPACITY_BYTES))
        self._family_tokens = (
            family_tokens if family_tokens is not None
            else env.env_int(FAMILY_TOKENS_ENV, DEFAULT_FAMILY_TOKENS))
        self._lock = threading.Lock()
        # digest -> _Entry; families in LRU order (move_to_end on every
        # touch; the first is the coldest).
        self._index: Dict[str, _Entry] = {}
        self._families: 'OrderedDict[str, set]' = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.evictions = 0
        self.torn_dropped = 0
        os.makedirs(root, exist_ok=True)
        self._load()

    # ------------------------------------------------------------ loading

    def _load(self) -> None:
        """Rebuild the index from disk (a process restart, the tier's
        reason to exist). Tmp files of interrupted spills are swept;
        entries that fail to parse are dropped, not served."""
        for fam in sorted(os.listdir(self.root)):
            fam_dir = os.path.join(self.root, fam)
            if not os.path.isdir(fam_dir):
                continue
            for name in sorted(os.listdir(fam_dir)):
                path = os.path.join(fam_dir, name)
                if not name.endswith('.json'):
                    # A crash between the tmp write and the rename.
                    _unlink(path)
                    continue
                entry = self._parse_entry(path)
                if entry is None:
                    self.torn_dropped += 1
                    _unlink(path)
                    continue
                digest = name[:-len('.json')]
                self._index[digest] = entry
                self._families.setdefault(entry.family, set()).add(digest)
                self._bytes += entry.nbytes

    def _parse_entry(self, path: str) -> Optional[_Entry]:
        """Metadata-only validation of one entry on disk; None for
        anything torn or malformed (the caller drops it)."""
        try:
            nbytes = os.path.getsize(path)
            with open(path, 'r', encoding='utf-8') as f:
                body = json.load(f)
            tokens = tuple(int(t) for t in body['prompt'])
            bk = int(body['block_k'])
            matched = int(body['matched_tokens'])
            dtype = str(body['kv_cache_dtype'])
            if (not tokens or bk <= 0 or matched != len(tokens)
                    or matched % bk or not body['arrays']):
                return None
        except (OSError, ValueError, TypeError, KeyError):
            return None
        return _Entry(tokens, family_digest(tokens, self._family_tokens),
                      path, nbytes, bk, dtype)

    # ------------------------------------------------------------- writes

    def put(self, tokens: Sequence[int], payload: Dict[str, Any]) -> bool:
        """Persist one published radix run (a decoded payload with
        ``from_tokens == 0``: spills ship whole runs, so any fetcher
        offset is served by slicing). False on a validation failure or a
        disk error (the spiller backs off); a run already stored is a
        cheap True."""
        tokens = tuple(int(t) for t in tokens)
        try:
            matched = int(payload['matched_tokens'])
            bk = int(payload['block_k'])
            arrays = payload['arrays']
        except (KeyError, TypeError, ValueError):
            return False
        if (not tokens or int(payload.get('from_tokens', -1)) != 0
                or matched != len(tokens) or bk <= 0 or matched % bk
                or not arrays):
            return False
        digest = _entry_digest(tokens)
        with self._lock:
            if digest in self._index:
                self._touch_family(self._index[digest].family)
                return True
        fam = family_digest(tokens, self._family_tokens)
        fam_dir = os.path.join(self.root, fam)
        os.makedirs(fam_dir, exist_ok=True)
        body = prefix_transfer.encode_payload(
            matched, 0, bk, payload['kv_cache_dtype'], arrays)
        body['prompt'] = list(tokens)
        data = json.dumps(body).encode('utf-8')
        del body
        path = os.path.join(fam_dir, digest + '.json')
        dtype = str(payload['kv_cache_dtype'])
        if chaos.should_fire('store_torn_entry'):
            # A spiller killed mid-write: half the bytes at the final
            # path. The spiller believes it landed; reads and restarts
            # must treat the entry as absent.
            try:
                with open(path, 'wb') as f:
                    f.write(data[:len(data) // 2])
            except OSError:
                return False
            with self._lock:
                self._admit_entry(digest, _Entry(
                    tokens, fam, path, len(data) // 2, bk, dtype))
            return True
        tmp = path + f'.tmp-{os.getpid()}-{threading.get_ident()}'
        try:
            with open(tmp, 'wb') as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            _unlink(tmp)
            return False
        with self._lock:
            self._admit_entry(digest, _Entry(tokens, fam, path, len(data),
                                             bk, dtype))
        return True

    def _admit_entry(self, digest: str, entry: _Entry) -> None:
        """Index one entry just written (lock held), then evict cold
        families over capacity. A stored strict prefix of the new run
        stays: ``get`` probes by exact run, so the shared head and a
        longer tail-specific run serve different fetchers."""
        self._index[digest] = entry
        self._families.setdefault(entry.family, set()).add(digest)
        self._touch_family(entry.family)
        self._bytes += entry.nbytes
        self.spills += 1
        self._evict_over_capacity(keep=entry.family)

    def _drop_entry(self, digest: str) -> None:
        entry = self._index.pop(digest, None)
        if entry is None:
            return
        fam = self._families.get(entry.family)
        if fam is not None:
            fam.discard(digest)
            if not fam:
                self._families.pop(entry.family, None)
        self._bytes -= entry.nbytes
        _unlink(entry.path)

    def _touch_family(self, family: str) -> None:
        if family in self._families:
            self._families.move_to_end(family)

    def _evict_over_capacity(self, keep: Optional[str] = None) -> None:
        """LRU-evict whole families until under capacity (lock held).
        ``keep``, the family just touched, survives even when it alone
        exceeds capacity: evicting the entry being admitted would make an
        undersized knob a store that caches nothing."""
        while self._bytes > self.capacity_bytes and self._families:
            victim = next(iter(self._families))
            if victim == keep and len(self._families) == 1:
                break
            if victim == keep:
                # Rotate the protected family to the warm end; the next
                # is the true coldest.
                self._families.move_to_end(victim)
                victim = next(iter(self._families))
            for digest in list(self._families.get(victim, ())):
                self._drop_entry(digest)
            self._families.pop(victim, None)
            self.evictions += 1

    # -------------------------------------------------------------- reads

    def get(self, tokens: Sequence[int], from_tokens: int,
            block_k: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The longest stored prefix of ``tokens`` extending past
        ``from_tokens``, as a decoded payload sliced to that offset (a
        multiple of the entry's block_k). None is a miss, torn entries
        included (they are dropped on contact)."""
        if chaos.should_fire('store_slow'):
            time.sleep(chaos.store_slow_seconds())
        tokens = tuple(int(t) for t in tokens)
        from_tokens = int(from_tokens)
        entry = digest = None
        with self._lock:
            # Longest prefix by hash probe. The caller's block_k sets the
            # stride; without it (the store-side handler) probe every
            # stored length of this family.
            if block_k and block_k > 0:
                lengths = range((len(tokens) // block_k) * block_k, 0,
                                -block_k)
            else:
                fam = family_digest(tokens, self._family_tokens)
                lengths = sorted(
                    {len(self._index[d].tokens)
                     for d in self._families.get(fam, ())
                     if len(self._index[d].tokens) <= len(tokens)},
                    reverse=True)
            for n in lengths:
                if n <= from_tokens:
                    break
                d = _entry_digest(tokens[:n])
                e = self._index.get(d)
                if e is not None and e.tokens == tokens[:n]:
                    entry, digest = e, d
                    self._touch_family(e.family)
                    break
            if entry is None:
                self.misses += 1
                return None
        payload = self._read_payload(digest, entry)
        if payload is None:
            return None
        return self._slice_payload(payload, from_tokens)

    def _read_payload(self, digest: str,
                      entry: _Entry) -> Optional[Dict[str, Any]]:
        """Load and decode one entry; a torn or corrupt body drops the
        entry (counted) and reads as a miss."""
        try:
            with open(entry.path, 'r', encoding='utf-8') as f:
                body = json.load(f)
            payload = prefix_transfer.decode_payload(body)
        except (OSError, ValueError):
            payload = None
        if (payload is None or not payload['arrays']
                or payload['matched_tokens'] != len(entry.tokens)):
            with self._lock:
                self._drop_entry(digest)
                self.torn_dropped += 1
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return payload

    @staticmethod
    def _slice_payload(payload: Dict[str, Any],
                       from_tokens: int) -> Optional[Dict[str, Any]]:
        """Re-base a whole-run payload at the caller's offset: drop the
        blocks before ``from_tokens`` (the fetcher has them)."""
        bk = payload['block_k']
        if from_tokens % bk or from_tokens >= payload['matched_tokens']:
            return None
        start = from_tokens // bk
        return {
            'matched_tokens': payload['matched_tokens'],
            'from_tokens': from_tokens,
            'block_k': bk,
            'kv_cache_dtype': payload['kv_cache_dtype'],
            'arrays': {name: a[:, start:]
                       for name, a in payload['arrays'].items()},
        }

    def get_by_digest(self, digest: str
                      ) -> Optional[Tuple[List[int], Dict[str, Any]]]:
        """Pre-warm lookup: the longest entry of the family ``digest``
        names (a family key or an entry digest), as (tokens, whole-run
        payload): what a joining replica needs to warm a family it has
        never seen a prompt of."""
        with self._lock:
            candidates = list(self._families.get(digest, ()))
            if not candidates and digest in self._index:
                candidates = [digest]
            if not candidates:
                self.misses += 1
                return None
            best = max(candidates, key=lambda d: len(self._index[d].tokens))
            entry = self._index[best]
            self._touch_family(entry.family)
        payload = self._read_payload(best, entry)
        if payload is None:
            return None
        return list(entry.tokens), payload

    def stats(self) -> Dict[str, Any]:
        """The store block of ``/slo`` and ``GET /prefix_blocks``."""
        with self._lock:
            return {
                'entries': len(self._index),
                'families': len(self._families),
                'bytes': self._bytes,
                'capacity_bytes': self.capacity_bytes,
                'hits': self.hits,
                'misses': self.misses,
                'spills': self.spills,
                'evictions': self.evictions,
                'torn_dropped': self.torn_dropped,
            }

    def families(self) -> List[str]:
        """Family keys, coldest first (the pre-warm plane's menu)."""
        with self._lock:
            return list(self._families)


# --------------------------------------------------------------- transport
# The store speaks the peer protocol: a fetch is prefix_transfer.http_fetch
# against the store URL; a spill POSTs the same encoded body with its
# arrays (the handler tells the shapes apart by their keys).


def _post_json(store_url: str, data: bytes,
               budget_seconds: float) -> Optional[Any]:
    """``POST <store>/prefix_blocks`` (``prefix_transfer.post``): the
    parsed JSON reply of a 200, else None."""
    raw = prefix_transfer.post(store_url, '/prefix_blocks', data,
                               budget_seconds)
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


def http_store_fetch(store_url: str, tokens: Sequence[int],
                     from_tokens: int, budget_seconds: float,
                     instance: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
    """Fetch transport: the peer fetch's exchange. None on failure (the
    engine backs the store off)."""
    if chaos.should_fire('store_down'):
        return None
    return prefix_transfer.http_fetch(store_url, tokens, from_tokens,
                                      budget_seconds, instance=instance)


def http_store_spill(store_url: str, tokens: Sequence[int],
                     payload: Dict[str, Any],
                     budget_seconds: float) -> bool:
    """Spill transport: POST the encoded whole-run payload plus its
    prompt. True only on an acknowledged persist."""
    if chaos.should_fire('store_down'):
        return False
    body = prefix_transfer.encode_payload(
        payload['matched_tokens'], payload['from_tokens'],
        payload['block_k'], payload['kv_cache_dtype'], payload['arrays'])
    body['prompt'] = [int(t) for t in tokens]
    data = json.dumps(body).encode()
    del body
    reply = _post_json(store_url, data, budget_seconds)
    return bool(isinstance(reply, dict) and reply.get('ok'))


def http_store_prewarm_fetch(store_url: str, digest: str,
                             budget_seconds: float
                             ) -> Optional[Tuple[List[int], Dict[str, Any]]]:
    """Pre-warm transport: a digest family's longest stored run, as
    (tokens, decoded whole-run payload), or None."""
    if chaos.should_fire('store_down'):
        return None
    body = _post_json(store_url, json.dumps({'digest': str(digest)}).encode(),
                      budget_seconds)
    if not isinstance(body, dict) or 'prompt' not in body:
        return None
    payload = prefix_transfer.decode_payload(body)
    if payload is None:
        return None
    try:
        tokens = [int(t) for t in body['prompt']]
    except (TypeError, ValueError):
        return None
    return tokens, payload


# ---------------------------------------------------------------- serving


def handle_store_post(store: BlockStore,
                      body: Any) -> Tuple[int, Dict[str, Any]]:
    """The store role's ``POST /prefix_blocks``. Three body shapes, told
    apart by their keys:

    * ``arrays`` → spill: decode, persist, ``{'ok': bool}``;
    * ``digest`` → pre-warm: the family's longest run (encoded, with its
      ``prompt``), or ``{'ok': false}``;
    * otherwise → fetch (the peer body): the longest stored prefix past
      ``from_tokens``, or an honest empty payload.

    Returns (status, JSON body); a malformed body is a 400 with a reason,
    never a 500."""
    if not isinstance(body, dict):
        return 400, {'error': 'malformed body'}
    if 'arrays' in body:
        payload = prefix_transfer.decode_payload(body)
        tokens = body.get('prompt')
        if payload is None or not isinstance(tokens, list):
            return 400, {'error': 'malformed spill payload'}
        try:
            ok = store.put(tokens, payload)
        except (TypeError, ValueError):
            return 400, {'error': 'malformed spill payload'}
        return 200, {'ok': bool(ok)}
    if 'digest' in body:
        hit = store.get_by_digest(str(body['digest']))
        if hit is None:
            return 200, {'ok': False}
        tokens, payload = hit
        out = prefix_transfer.encode_payload(
            payload['matched_tokens'], payload['from_tokens'],
            payload['block_k'], payload['kv_cache_dtype'],
            payload['arrays'])
        out['prompt'] = tokens
        return 200, out
    try:
        tokens = [int(t) for t in body['prompt']]
        from_tokens = int(body.get('from_tokens', 0))
    except (KeyError, TypeError, ValueError):
        return 400, {'error': 'malformed fetch body'}
    payload = store.get(tokens, from_tokens)
    if payload is None:
        return 200, prefix_transfer.empty_payload(from_tokens, 0, '')
    return 200, prefix_transfer.encode_payload(
        payload['matched_tokens'], payload['from_tokens'],
        payload['block_k'], payload['kv_cache_dtype'], payload['arrays'])
