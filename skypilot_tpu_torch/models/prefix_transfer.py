"""Cross-replica KV block transfer: the wire format, the fetch and the push.

Counterpart of ``skypilot_tpu/models/prefix_transfer.py`` without the
block store's transports. A paged replica's radix cache holds the KV
blocks of the prompt prefixes it has served; a replica whose cache
misses pulls the matched blocks from a peer instead of prefilling them
again:

* The OWNER side (``serve/model_server.py`` ``POST /prefix_blocks``)
  radix-matches the posted token prefix on the engine loop thread and
  answers with the matched pool blocks, serialised by
  :func:`encode_payload`.
* The MISS side (``models/engine.py`` ``_prefix_fetch_into_cache``)
  POSTs the block-aligned prompt prefix to the configured peers
  (``SKYTPU_PREFIX_PEERS`` / ``--prefix-peers``), bounded by
  ``SKYTPU_PREFIX_FETCH_BUDGET_SECONDS``: a slow or dead peer degrades
  the admission to a local prefill, never stalls it.
* The PUSH direction (disaggregated prefill/decode): a prefill replica
  streams a request's finished pool blocks to a decode peer's
  ``POST /handoff_blocks`` with :func:`http_push`, bounded by
  ``SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS``; any failure degrades the
  request to decode-in-place on the prefill replica.

The wire format is the reference's, byte for byte, so blocks cross
between the two packages in both directions: the same JSON keys, the
same dtype names (``'bfloat16'``, ``'int8'``, ``'float32'``) and the
base64 of the raw little-endian bytes of each ``[L, n_blocks, block_k,
...]`` array. On this side a decoded array is a CPU ``torch.Tensor``:
numpy has no bfloat16 without ``ml_dtypes``, so bf16 rides through its
16 bits, as ``models/convert.py`` carries weights. The dtype survives
exactly (bf16 pools ship bf16 bytes, int8 pools int8 values plus their
fp32 scale planes), so a fetched block decodes bit for bit as the
owner's does.

Both transports are the standard library's ``http.client``, because the
card host has no ``requests``.
"""
import base64
import http.client
import json
import time
import urllib.parse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.utils import chaos

# Engine-side knobs (read in models/engine.py).
PREFIX_PEERS_ENV = 'SKYTPU_PREFIX_PEERS'
FETCH_BUDGET_ENV = 'SKYTPU_PREFIX_FETCH_BUDGET_SECONDS'
DEFAULT_FETCH_BUDGET_SECONDS = 0.5
FETCH_MIN_TOKENS_ENV = 'SKYTPU_PREFIX_FETCH_MIN_TOKENS'
# A peer whose fetch failed (timeout, connect error, garbage) is skipped
# for this long: without the backoff one dead peer would cost every
# eligible cold admission a budget's worth of engine-loop stall.
FETCH_BACKOFF_ENV = 'SKYTPU_PREFIX_FETCH_BACKOFF_SECONDS'
DEFAULT_FETCH_BACKOFF_SECONDS = 10.0
# The handoff's push direction: the budget of one push of a chunk's
# finished blocks to the decode peer. A slow decode peer degrades the
# request to decode-in-place; it never wedges the prefill loop.
PUSH_BUDGET_ENV = 'SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS'
DEFAULT_PUSH_BUDGET_SECONDS = 2.0

# Wire dtype name → (tensor dtype, numpy dtype carrying its bytes): the
# dtypes a pool holds (bf16 or fp32 K/V, int8 K/V with fp32 scales).
_WIRE_DTYPES = {
    'bfloat16': (torch.bfloat16, np.int16),
    'float32': (torch.float32, np.float32),
    'int8': (torch.int8, np.int8),
}
_WIRE_NAMES = {t: name for name, (t, _) in _WIRE_DTYPES.items()}
_READ_CHUNK = 64 * 1024


def encode_array(t: torch.Tensor) -> Dict[str, Any]:
    """One tensor → ``{'shape', 'dtype', 'data'}`` (base64 of its raw
    bytes, row-major)."""
    t = t.detach().to('cpu').contiguous()
    name = _WIRE_NAMES[t.dtype]
    carrier = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
    return {'shape': list(t.shape), 'dtype': name,
            'data': base64.b64encode(
                t.view(carrier).numpy().tobytes()).decode('ascii')}


def decode_array(d: Dict[str, Any]) -> torch.Tensor:
    """Inverse of :func:`encode_array`: a CPU tensor of the wire dtype.
    Raises KeyError on an unknown dtype and ValueError when the bytes do
    not fill the shape."""
    dtype, carrier = _WIRE_DTYPES[str(d['dtype'])]
    a = np.frombuffer(base64.b64decode(d['data']), dtype=carrier).reshape(
        [int(s) for s in d['shape']])
    return torch.from_numpy(a.copy()).view(dtype)


def empty_payload(from_tokens: int, block_k: int,
                  kv_cache_dtype: str) -> Dict[str, Any]:
    """An honest "nothing cached past from_tokens" reply. A transport
    returns THIS (not None) for a reachable but cold peer: None means a
    transport failure and puts the peer in the engine's backoff."""
    return {'matched_tokens': int(from_tokens),
            'from_tokens': int(from_tokens),
            'block_k': int(block_k),
            'kv_cache_dtype': kv_cache_dtype,
            'arrays': {}}


def encode_payload(matched_tokens: int, from_tokens: int, block_k: int,
                   kv_cache_dtype: str,
                   arrays: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The ``/prefix_blocks`` response body: the pool arrays covering
    blocks ``[from_tokens // block_k, matched_tokens // block_k)`` of the
    posted prefix, each ``[L, n, block_k, ...]``."""
    return {
        'matched_tokens': int(matched_tokens),
        'from_tokens': int(from_tokens),
        'block_k': int(block_k),
        'kv_cache_dtype': kv_cache_dtype,
        'arrays': {name: encode_array(a) for name, a in arrays.items()},
    }


def decode_payload(body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Inverse of :func:`encode_payload`; None for a malformed body (a
    corrupt peer reply degrades to a local prefill, it does not crash
    admission)."""
    try:
        return {
            'matched_tokens': int(body['matched_tokens']),
            'from_tokens': int(body['from_tokens']),
            'block_k': int(body['block_k']),
            'kv_cache_dtype': str(body['kv_cache_dtype']),
            'arrays': {str(name): decode_array(d)
                       for name, d in body['arrays'].items()},
        }
    except (KeyError, TypeError, ValueError):
        return None


def http_fetch(peer_url: str, tokens: Sequence[int], from_tokens: int,
               budget_seconds: float,
               instance: Optional[str] = None
               ) -> Optional[Dict[str, Any]]:
    """The default transport: ``POST <peer>/prefix_blocks`` with the
    block-aligned prompt prefix. Returns the decoded payload, ``{'self':
    True}`` when the peer is the calling engine (it echoes ``instance``),
    or None on any failure (connect error, timeout, non-200, malformed
    body). Half the budget bounds the connect and half each socket read,
    and the body is read under a wall-clock deadline of the whole budget:
    a peer that streams slowly, each read inside its timeout, still
    costs at most about one budget."""
    half = max(budget_seconds / 2, 1e-3)
    deadline = time.monotonic() + max(budget_seconds, 1e-3)
    url = urllib.parse.urlsplit(peer_url.rstrip('/') + '/prefix_blocks')
    if url.scheme not in ('http', 'https') or not url.hostname:
        return None
    conn_cls = (http.client.HTTPSConnection if url.scheme == 'https'
                else http.client.HTTPConnection)
    # budget_seconds rides along so the owner caps its export wait: past
    # the fetcher's timeout nobody reads the reply. ``instance`` lets the
    # owner answer "I am you" at once under a fleet-shared peers list.
    body = json.dumps({'prompt': [int(t) for t in tokens],
                       'from_tokens': int(from_tokens),
                       'budget_seconds': float(budget_seconds),
                       'instance': instance}).encode()
    chunks = []
    try:
        conn = conn_cls(url.hostname, url.port, timeout=half)
    except ValueError:
        return None
    try:
        conn.request('POST', url.path, body=body,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        while True:
            # read1: what one socket read brings, so the deadline is
            # checked as the body trickles in.
            chunk = resp.read1(_READ_CHUNK)
            if not chunk:
                break
            chunks.append(chunk)
            if time.monotonic() > deadline:
                return None
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()
    try:
        reply = json.loads(b''.join(chunks))
    except ValueError:
        return None
    if isinstance(reply, dict) and reply.get('self'):
        return {'self': True}
    return decode_payload(reply)


def http_push(peer_url: str, tokens: Sequence[int],
              payload: Dict[str, Any], budget_seconds: float,
              instance: Optional[str] = None) -> bool:
    """The handoff's transport: ``POST <peer>/handoff_blocks`` with the
    prompt prefix the payload's blocks cover. True only when the decode
    peer answers 200 with ``ok`` (the blocks are installed); any failure
    (connect error, timeout, non-200, an injection error, a malformed
    reply) is False, and the prefill side degrades to decode-in-place.

    The body is the fetch direction's wire format (:func:`encode_payload`
    of the engine's host snapshot) plus ``prompt`` and ``instance``, as
    the reference sends it. Half the budget bounds the connect and half
    each socket operation, and the reply is read under a wall-clock
    deadline of the whole budget from the connect (the serialising before
    it is not counted). The ``handoff_truncate`` chaos point ships half
    the serialised body."""
    body = encode_payload(payload['matched_tokens'],
                          payload['from_tokens'], payload['block_k'],
                          payload['kv_cache_dtype'], payload['arrays'])
    body['prompt'] = [int(t) for t in tokens]
    body['instance'] = instance
    data = json.dumps(body)
    del body
    if chaos.should_fire('handoff_truncate'):
        # A truncated block stream: the decode side sees malformed JSON,
        # answers 400, and the prefill side degrades.
        data = data[:len(data) // 2]
    data = data.encode()
    half = max(budget_seconds / 2, 1e-3)
    deadline = time.monotonic() + max(budget_seconds, 1e-3)
    url = urllib.parse.urlsplit(peer_url.rstrip('/') + '/handoff_blocks')
    if url.scheme not in ('http', 'https') or not url.hostname:
        return False
    conn_cls = (http.client.HTTPSConnection if url.scheme == 'https'
                else http.client.HTTPConnection)
    chunks = []
    try:
        conn = conn_cls(url.hostname, url.port, timeout=half)
    except ValueError:
        return False
    try:
        conn.request('POST', url.path, body=data,
                     headers={'Content-Type': 'application/json'})
        del data
        resp = conn.getresponse()
        if resp.status != 200:
            return False
        while True:
            chunk = resp.read1(_READ_CHUNK)
            if not chunk:
                break
            chunks.append(chunk)
            if time.monotonic() > deadline:
                return False
    except (OSError, ValueError, http.client.HTTPException):
        return False
    finally:
        conn.close()
    try:
        reply = json.loads(b''.join(chunks))
    except ValueError:
        return False
    return bool(isinstance(reply, dict) and reply.get('ok'))
