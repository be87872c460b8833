"""Model server: HTTP + SSE streaming over the port's decode engine.

Counterpart of ``skypilot_tpu/serve/model_server.py`` for this slice,
built on the standard library (``http.server.ThreadingHTTPServer``), with
the engine loop on its own thread. Endpoints:

* ``POST /generate`` — body ``{"prompt": [token ids...]}`` or
  ``{"text": "..."}`` plus optional ``max_new_tokens``, ``stream``
  (default true) and ``tenant`` (or header ``X-Tenant``). Streaming
  replies are Server-Sent Events, one ``data: {"token", "text",
  "done"}`` event per token, the last one adding ``finish_reason`` and
  ``generated``; ``stream: false`` returns one JSON object with
  ``tokens``, ``text``, ``finish_reason`` and ``generated``. Bad bodies
  answer 400; a full admission queue (``SKYTPU_SERVE_MAX_QUEUE``,
  default 256, 0 = no bound) 429 with ``Retry-After: 1``; a draining or
  stopped server 503 with ``Retry-After: 1``; a permanently failed
  engine 503 with ``Retry-After: 30``. An engine crash mid-request
  answers 500 (the supervisor restarts the engine; queued requests
  survive it).
* ``POST /drain`` — 202; the server stops taking requests, lets the
  in-flight ones finish for up to ``SKYTPU_DRAIN_TIMEOUT_SECONDS``
  (default 30), then stops. SIGTERM does the same in standalone mode.
* ``GET /healthz`` — 200 ``ok staleness_seconds=... <stats>``; 503 when
  the engine failed for good, the server is not running (draining,
  stopped), the engine thread died, or the engine loop's heartbeat is
  older than ``SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS`` (unset: no bound).
  The stats part of the line starts with ``role=<role>``.
* ``GET /stats`` — the engine's stats as JSON, with the speculative-
  decoding and chunked-prefill counters under ``spec``.
* ``GET /metrics`` — the package registry's Prometheus text exposition
  (``skytpu_engine_*``, ``skytpu_request_*``, ``skytpu_journal_*``,
  ``skytpu_server_*``).
* ``GET /debug/requests?n=`` — in-flight and the last ``n`` (default 50)
  completed request records with their phase breakdowns;
  ``GET /debug/engine?n=`` — the engine's stats and its step profile
  (the last ``n``, default 32, steps).
* ``GET /slo`` — the rolling SLO surface (``ttft_seconds``,
  ``per_token_seconds``, ... p50/p95/p99 over the completed ring) with
  the reference's ``resilience``, ``spec``, ``cache``, ``role``,
  ``handoff``, ``store`` and ``steps`` blocks.
* ``GET/POST /journal`` — filtered rows of this replica's journal
  (``trace_id``, ``kinds``, ``entity``, ``since_id``, ``limit``; the
  reference's ``journal.serve_query``). 404 unless the replica has
  prefix peers or ``SKYTPU_JOURNAL_PEERS`` names the hosts allowed to
  pull it.
* ``POST /prefix_blocks`` — the owner side of the cross-replica prefix
  fetch: body ``{"prompt": [token ids], "from_tokens", "budget_seconds",
  "instance"}``; the engine loop radix-matches the prompt and the reply
  carries the matched pool blocks past ``from_tokens`` in the wire
  format of ``models/prefix_transfer.py`` (an empty match when nothing
  is cached past it; ``{"self": true}`` when ``instance`` is this
  engine's own). 400 on an unpaged replica or a malformed body, 404
  without prefix peers. A server that hosts a block store (``store=``,
  or ``--role store`` with ``--store-dir`` / ``SKYTPU_STORE_DIR``)
  answers it from disk instead (``block_store.handle_store_post``: a body
  with ``arrays`` is a spill, one with ``digest`` a pre-warm lookup, any
  other a fetch; a malformed body is a 400, never a 500), and ``GET
  /prefix_blocks`` answers the store's stats (404 without a store).
* ``POST /prewarm`` — body ``{"digests": [family digests]}``: the replica
  pulls each family's longest run from its configured store
  (``SKYTPU_STORE_URL`` / ``--store-url``; never a URL from the request),
  at most ``SKYTPU_PREWARM_MAX_DIGESTS`` (default 8) of them, each within
  ``SKYTPU_PREWARM_BUDGET_SECONDS`` (default 2), and installs it as a
  handoff, so its first request of the family is a prefix hit. Answers
  ``{"ok": true, "warmed", "missed", "tokens"}``; 400 on an unpaged
  replica or a malformed body, 404 without a store, 503 unless running.
* ``POST /prefill_handoff`` — the prefill leg of disaggregated serving
  (the load balancer's ``disagg`` policy): the ``/generate`` body, with
  the decode replica named by ``X-Skytpu-Handoff-Target``. The prompt is
  prefilled here in chunks and its full KV blocks are pushed to that
  replica's ``/handoff_blocks`` as they finish, each push within
  ``SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS`` (default 2). A completed handoff
  answers ``{"handoff": "complete", "decode_url", "prompt_len",
  "max_new_tokens"}`` with ``X-Skytpu-Handoff: complete``, and the same
  ``/generate`` body sent to the decode replica is then a near-full
  prefix hit there. Anything else (unpaged, no or an untrusted target,
  a target in backoff, a short prompt, a failed push) degrades to
  decode-in-place: the reply is this replica's ``/generate`` reply with
  ``X-Skytpu-Handoff: degraded``. The target header only selects among
  the configured prefix peers; it never adds a URL.
* ``POST /handoff_blocks`` — the decode side: one pushed chunk (the wire
  format plus ``prompt``), installed by the engine loop into the pool
  and the radix cache; ``{"ok": ...}``. 400 on an unpaged replica or a
  malformed body, 404 without prefix peers, 503 with ``Retry-After``
  unless running, 500 when the ``handoff_decode_death`` chaos point
  fires.

Every ``/generate`` answers an ``X-Request-Id``: the client's header, or
a minted trace id. It is the request's trace id (``X-Skytpu-Trace-Id``
wins when a load balancer sends one), so the request's
``server.request`` span rows and its engine rows
(``engine.admit``/``evict``/``slow_request``) share it, nested under
the span (and under the caller's span when ``X-Skytpu-Span-Id`` is
given).

Run as ``python -m skypilot_tpu_torch.serve.model_server`` with the
reference's flag names. The engine runs on CUDA unless ``--device cpu``
is given. Speculative decoding is on with ``--paged --spec-k K
[--drafter-layers D]`` (or ``SKYTPU_SPEC_K`` / ``SKYTPU_SPEC_DRAFTER_LAYERS``),
chunked prefill with ``--paged --prefill-chunk N`` (or
``SKYTPU_PREFILL_CHUNK``), the cross-replica prefix fetch with ``--paged
--prefix-peers URL,URL`` (or ``SKYTPU_PREFIX_PEERS``; the list is the
trust set: only its members are fetched from, pushed to or accepted
from, and only a replica that has one exports its blocks). ``--role
prefill|decode|mixed|store`` (or ``SKYTPU_REPLICA_ROLE``; anything
unknown reads as ``mixed``) is the replica's serving role, shown on
``/healthz`` and ``/slo``, where the load balancer learns it; ``store``
with ``--store-dir DIR`` (or ``SKYTPU_STORE_DIR``) hosts the durable
block store over DIR. ``--store-url URL`` (or ``SKYTPU_STORE_URL``;
paged only) makes a replica fetch cold prefixes from that store after
its peers and spill its published runs to it
(``models/block_store.py``).
``SKYTPU_CHAOS`` arms the fault points ``engine_step_raise``,
``slow_step``, ``drain_hang``, ``replica_500``, ``handoff_decode_death``,
``handoff_truncate``, ``journal_write_stall``, ``journal_disk_full``,
``store_down``, ``store_torn_entry`` and ``store_slow``
(``utils/chaos.py``).
``--int8`` serves int8 weights (the seven per-layer GEMM weights
quantised per output channel, ``decode.quantize_params``);
``--checkpoint-dir DIR`` restores the newest complete params checkpoint
under DIR (``models/checkpoint.save_params``) before quantising, or
serves the random init with a warning when there is none. ``--tp N``
(or ``SKYTPU_SERVE_TP``, parsed strictly: a malformed value stops the
start) serves a paged replica tensor-parallel over N ranks, one card
each over NCCL (``parallel/tp.py``): this process is rank 0 and starts
the N - 1 workers. Under a gang (``parallel/distributed.py``) every
process runs this entry point: process 0 serves and the others run the
TP worker loop.

Tokenizer note: the models are research checkpoints without a shipped
tokenizer, so ``text`` uses a byte-level demo codec (UTF-8 bytes → ids;
ids → bytes mod 256). Real deployments send token ids.
"""
import argparse
import functools
import http.server
import json
import logging
import os
import queue
import signal
import threading
import time
import urllib.parse
import weakref
from typing import Optional

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import block_store, checkpoint, decode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama, prefix_transfer
from skypilot_tpu_torch.observability import journal
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import trace as trace_lib
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import tp as tp_lib
from skypilot_tpu_torch.utils import chaos, env

logger = logging.getLogger(__name__)

REPLICA_PORT_ENV = 'SKYTPU_REPLICA_PORT'
REQUEST_TIMEOUT_ENV = 'SKYTPU_MODEL_SERVER_REQUEST_TIMEOUT'
# Speculative decoding: draft tokens per engine step (0 disables) and the
# truncated-layer drafter's depth, when the CLI does not give them.
SPEC_K_ENV = 'SKYTPU_SPEC_K'
SERVE_TP_ENV = 'SKYTPU_SERVE_TP'
SPEC_DRAFTER_LAYERS_ENV = 'SKYTPU_SPEC_DRAFTER_LAYERS'
# Admission-queue backpressure: at this queue depth /generate answers
# 429 + Retry-After instead of queueing without bound. 0 disables.
MAX_QUEUE_ENV = 'SKYTPU_SERVE_MAX_QUEUE'
DEFAULT_MAX_QUEUE = 256
# Graceful drain: how long in-flight requests get to finish.
DRAIN_TIMEOUT_ENV = 'SKYTPU_DRAIN_TIMEOUT_SECONDS'
DEFAULT_DRAIN_TIMEOUT_SECONDS = 30.0
# stop(): how long to wait for the engine thread before logging it as
# wedged (it still holds the device).
STOP_TIMEOUT_ENV = 'SKYTPU_SERVER_STOP_TIMEOUT_SECONDS'
DEFAULT_STOP_TIMEOUT_SECONDS = 10.0
# /healthz answers 503 once the engine loop's heartbeat is older than
# this (unset, empty or unparseable: no bound).
HEALTHZ_MAX_STALENESS_ENV = 'SKYTPU_HEALTHZ_MAX_STALENESS_SECONDS'
# The journal query plane's trust set: hosts allowed to pull this
# replica's /journal. /journal answers when the replica is configured
# into a fleet (prefix peers) or this names the head(s); with neither it
# answers 404: a replica outside any fleet must not export its journal
# to whoever reaches its port.
JOURNAL_PEERS_ENV = 'SKYTPU_JOURNAL_PEERS'
# Disaggregated prefill/decode: this replica's serving role, shown on
# /healthz and /slo (the load balancer's `disagg` policy reads it there).
# 'mixed' is monolithic serving.
REPLICA_ROLE_ENV = 'SKYTPU_REPLICA_ROLE'
_ROLES = ('prefill', 'decode', 'mixed', 'store')
# Store-warmed scale-up: how many digest families one POST /prewarm may
# pull from the durable store, and each one's fetch budget. Both bound a
# prewarm's cost on a replica that is about to take traffic.
PREWARM_MAX_DIGESTS_ENV = 'SKYTPU_PREWARM_MAX_DIGESTS'
DEFAULT_PREWARM_MAX_DIGESTS = 8
PREWARM_BUDGET_ENV = 'SKYTPU_PREWARM_BUDGET_SECONDS'
DEFAULT_PREWARM_BUDGET_SECONDS = 2.0
# skytpu_server_state gauge values (/healthz carries the string).
_STATE_VALUES = {'starting': 0, 'running': 0, 'draining': 1,
                 'stopped': 2}


def read_role(raw: Optional[str]) -> str:
    """The reference replica's reading of its role: stripped, lowercased,
    anything unknown degraded to 'mixed'."""
    role = (raw or 'mixed').strip().lower()
    return role if role in _ROLES else 'mixed'


def encode_text(text: str, vocab_size: int) -> list:
    """Demo byte-level codec: UTF-8 bytes → token ids (< vocab_size)."""
    return [b % vocab_size for b in text.encode('utf-8')]


def decode_tokens(tokens) -> str:
    """Inverse demo codec: ids → bytes (mod 256), lossy for vocab>256."""
    return bytes(t % 256 for t in tokens).decode('utf-8',
                                                 errors='replace')


def serve_tp(tp: Optional[int] = None) -> int:
    """The TP degree: ``tp`` when given, else ``SKYTPU_SERVE_TP`` or 1.
    The knob is parsed strictly, as the reference parses it: a malformed
    value raises instead of starting a replica unsharded, and a
    nonpositive one passes through for the engine to refuse."""
    if tp is not None:
        return int(tp)
    raw = os.environ.get(SERVE_TP_ENV, '')
    return int(raw) if raw else 1


def _param_template(cfg: llama.LlamaConfig) -> llama.Params:
    """The params tree as meta tensors: keys, shapes and dtypes, no
    storage."""
    def meta(shape):
        return torch.empty(shape, dtype=cfg.dtype, device='meta')

    shapes = llama.param_shapes(cfg)
    return {name: ({n: meta(s) for n, s in shape.items()}
                   if name == 'layers' else meta(shape))
            for name, shape in shapes.items()}


def build_engine(model: str, num_slots: int, max_len: int,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 kv_int8: bool = False, int8: bool = False,
                 attn: str = 'kernel', step_chunk: int = 4,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 paged: bool = False,
                 num_blocks: Optional[int] = None,
                 block_k: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 drafter_layers: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_peers: Optional[list] = None,
                 store_url: Optional[str] = None,
                 device: Optional[str] = None,
                 params: Optional[llama.Params] = None,
                 rounds: str = 'graph', tp: Optional[int] = None,
                 tp_group: Optional[tp_lib.TPGroup] = None,
                 tp_devices: Optional[list] = None,
                 tp_backend: Optional[str] = None
                 ) -> engine_lib.DecodeEngine:
    """Assemble params + configs into a DecodeEngine (CLI, tests and
    ``chip_smoke.py``). Params are random from ``seed`` unless given;
    with ``checkpoint_dir`` the newest complete params checkpoint there
    replaces them (its tree must match theirs, or ValueError), then
    ``int8`` quantises the layer weights, as the reference does.
    ``device`` defaults to CUDA and raises without a card. ``spec_k`` /
    ``drafter_layers`` default from ``SKYTPU_SPEC_K`` /
    ``SKYTPU_SPEC_DRAFTER_LAYERS``; the drafter depth is clamped to the
    model's layer count, as the reference does. ``prefill_chunk``
    defaults from ``SKYTPU_PREFILL_CHUNK``, ``prefix_peers`` from
    ``SKYTPU_PREFIX_PEERS`` and ``store_url`` from ``SKYTPU_STORE_URL``
    (all three paged only). ``rounds`` is the engine's (CUDA graphs or
    eager on the card); the CLI leaves it at its default.

    ``tp`` (default ``SKYTPU_SERVE_TP`` or 1, :func:`serve_tp`) serves
    the replica tensor-parallel. The group is ``tp_group`` when given
    (its ranks and backend are the caller's); else the gang's, when
    ``parallel/distributed.maybe_initialize`` formed one; else one made
    here over ``tp_devices`` (one a rank, default the visible cards, or
    CPU ranks when ``device`` is the CPU) with ``tp_backend`` (default
    NCCL on cards, gloo on the CPU). The engine closes a group it was
    not given (:meth:`DecodeEngine.close`)."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[model]
    if checkpoint_dir:
        # Without given params the tree is checked against meta tensors,
        # so no random init is drawn beside the restored weights.
        template = params if params is not None else _param_template(cfg)
        restored = checkpoint.restore_latest_params(checkpoint_dir,
                                                    template, dev)
        if restored is None:
            logger.warning('No complete checkpoint under %s; serving '
                           'random init.', checkpoint_dir)
        else:
            params, step = restored
            logger.info('Restored checkpoint step %d from %s.', step,
                        checkpoint_dir)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = llama.init_params(cfg, gen, dev)
    if int8:
        params = decode.quantize_params(params)
    dcfg_kwargs = dict(max_len=max_len, temperature=temperature,
                       eos_id=eos_id, decode_attention=attn,
                       kv_cache_dtype='int8' if kv_int8 else 'bf16')
    if block_k is not None:
        dcfg_kwargs['kernel_block_k'] = block_k
    if spec_k is None:
        spec_k = env.env_int(SPEC_K_ENV, 0)
    if drafter_layers is None:
        drafter_layers = env.env_int(SPEC_DRAFTER_LAYERS_ENV, 1)
    if spec_k:
        dcfg_kwargs['spec_k'] = spec_k
        dcfg_kwargs['spec_drafter_layers'] = min(drafter_layers,
                                                 cfg.n_layers)
    tp = serve_tp(tp)
    owns_group = False
    if tp > 1 and tp_group is None:
        # Validated before any worker starts.
        engine_lib.check_tp(tp, None, cfg, paged, rounds)
        if distributed.maybe_initialize(
                'gloo' if dev.type == 'cpu' else None):
            tp_group = tp_lib.gang_group(tp, dev.type)
        else:
            tp_group = tp_lib.local_group(tp, tp_devices, tp_backend,
                                          platform=dev.type)
        owns_group = True
    sampler = torch.Generator(device=(tp_group.device if tp_group
                                      else dev))
    sampler.manual_seed(seed)
    try:
        eng = engine_lib.DecodeEngine(
            params, cfg, decode.DecodeConfig(**dcfg_kwargs), num_slots,
            step_chunk=step_chunk, generator=sampler, name=model,
            paged=paged, num_blocks=num_blocks,
            prefill_chunk=prefill_chunk, prefix_peers=prefix_peers,
            store_url=store_url, rounds=rounds, tp=tp, tp_group=tp_group,
            own_group=owns_group)
    except BaseException:
        if owns_group:
            tp_group.close()
        raise
    return eng


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, model_server: 'ModelServer'):
        # Held weakly: the ModelServer holds this server, and a cycle
        # would keep a stopped replica's engine and cache alive until the
        # cyclic collector runs.
        self._model_server = weakref.ref(model_server)
        super().__init__(address, _Handler)

    @property
    def model_server(self) -> 'ModelServer':
        return self._model_server()


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = 'skypilot-tpu-torch'

    def log_message(self, format, *args):  # pylint: disable=redefined-builtin
        logger.debug('%s ' + format, self.address_string(), *args)

    def send_json(self, status: int, obj, headers=None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def send_text(self, status: int, text: str) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header('Content-Type', 'text/plain; charset=utf-8')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def query(self) -> dict:
        """The URL's query parameters (the first of each)."""
        qs = urllib.parse.urlsplit(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(qs).items()}

    def query_int(self, key: str, default: int) -> int:
        try:
            return int(self.query().get(key, default))
        except ValueError:
            return default

    def do_GET(self):  # pylint: disable=invalid-name
        ms = self.server.model_server
        path = self.path.split('?', 1)[0]
        if path == '/healthz':
            status, text = ms.health()
            self.send_text(status, text)
        elif path == '/stats':
            self.send_json(200, {**ms.engine.stats(),
                                 'spec': ms.engine.spec_stats()})
        elif path == '/metrics':
            self.send_text(200, metrics_lib.generate_latest().decode())
        elif path == '/debug/requests':
            self.send_json(200, ms.engine.telemetry.snapshot(
                self.query_int('n', 50)))
        elif path == '/debug/engine':
            self.send_json(200, {
                'stats': ms.engine.stats(),
                'step_profile': ms.engine.profiler.snapshot(
                    self.query_int('n', 32))})
        elif path == '/slo':
            self.send_json(200, ms.slo())
        elif path == '/journal':
            ms.handle_journal(self, {})
        elif path == '/prefix_blocks':
            ms.handle_store_stats(self)
        else:
            self.send_json(404, {'error': f'no route {path}'})

    def do_POST(self):  # pylint: disable=invalid-name
        ms = self.server.model_server
        path = self.path.split('?', 1)[0]
        if path == '/generate':
            ms.handle_generate(self)
        elif path == '/prefix_blocks':
            ms.handle_prefix_blocks(self)
        elif path == '/prefill_handoff':
            ms.handle_generate(self, handoff=True)
        elif path == '/handoff_blocks':
            ms.handle_handoff_blocks(self)
        elif path == '/prewarm':
            ms.handle_prewarm(self)
        elif path == '/journal':
            try:
                length = int(self.headers.get('Content-Length') or 0)
                body = json.loads(self.rfile.read(length) or b'{}')
            except (ValueError, UnicodeDecodeError):
                body = {}  # a malformed filter serves the unfiltered page
            ms.handle_journal(self, body if isinstance(body, dict) else {})
        elif path == '/drain':
            initiated = ms.begin_drain('http')
            self.send_json(202, {'state': ms.state, 'initiated': initiated,
                                 'drain_timeout_seconds': ms.drain_timeout})
        else:
            self.send_json(404, {'error': f'no route {path}'})


class ModelServer:
    """Threaded HTTP front end + engine loop thread, one per replica.

    Lifecycle: starting → running → draining → stopped. ``stop()`` must
    not run on the thread that runs ``serve_forever`` (``shutdown()``
    waits for that loop to return), so a drain stops the server from
    its own thread."""

    def __init__(self, engine: engine_lib.DecodeEngine, port: int,
                 host: str = '0.0.0.0',
                 default_max_new_tokens: int = 128,
                 role: Optional[str] = None,
                 store: Optional[block_store.BlockStore] = None):
        self.engine = engine
        # The journal file of this replica's direct writes and /journal
        # reads: the engine's (None: the host journal).
        self._journal_db = engine.journal_db
        # Serving role: the argument, else SKYTPU_REPLICA_ROLE, else
        # mixed; a mistyped role serves as mixed rather than stopping the
        # replica.
        self.role = read_role(role or os.environ.get(REPLICA_ROLE_ENV))
        # Durable block store hosting: an explicit store, or the store
        # role over SKYTPU_STORE_DIR. A hosting server answers
        # /prefix_blocks from disk instead of the radix export: the same
        # endpoint and wire format, so replicas fetch from peers and the
        # store alike.
        if store is None and self.role == 'store':
            store_dir = os.environ.get(block_store.STORE_DIR_ENV,
                                       '').strip()
            if store_dir:
                store = block_store.BlockStore(store_dir)
        self.store = store
        # /prewarm counters (handler threads run concurrently).
        self._prewarm_lock = threading.Lock()
        self._prewarms = 0
        self._prewarm_tokens = 0
        self.host = host
        self.port = port  # rebound to the OS-assigned port when 0
        self.default_max_new_tokens = default_max_new_tokens
        self.request_timeout = env.env_float(REQUEST_TIMEOUT_ENV, 300.0)
        self.max_queue = env.env_int(MAX_QUEUE_ENV, DEFAULT_MAX_QUEUE)
        self.max_staleness = env.env_optional_float(
            HEALTHZ_MAX_STALENESS_ENV)
        self.drain_timeout = env.env_float(DRAIN_TIMEOUT_ENV,
                                           DEFAULT_DRAIN_TIMEOUT_SECONDS)
        self._started_at: Optional[float] = None
        self._stop = threading.Event()
        self._engine_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None
        self._httpd: Optional[_HTTPServer] = None
        self._serving = False
        self._state = 'starting'
        self._state_lock = threading.Lock()
        self._drain_thread: Optional[threading.Thread] = None
        self._drains = 0

    @property
    def state(self) -> str:
        return self._state

    # ---------------------------------------------------------- lifecycle

    def _bind(self) -> None:
        self._httpd = _HTTPServer((self.host, self.port), self)
        self.port = self._httpd.server_address[1]
        # URLs that plainly address this replica never enter its prefix
        # fetches (a self-fetch would stall the loop for a whole budget);
        # other aliases are caught by the instance-id echo.
        for host in {self.host, '127.0.0.1', 'localhost'}:
            self.engine.register_self_url(f'http://{host}:{self.port}')
        self._started_at = time.time()
        self._engine_thread = threading.Thread(
            target=self.engine.run_forever, args=(self._stop,),
            daemon=True, name='skytorch-engine')
        self._engine_thread.start()
        self._serving = True
        self._set_state('running')
        logger.info('Model server listening on :%d (%d slots, max_len %d, '
                    '%s).', self.port, self.engine.num_slots,
                    self.engine.dcfg.max_len, self.engine.device)

    def start(self) -> int:
        """Serve from a daemon thread (tests, ``chip_smoke.py``);
        returns the bound port."""
        self._bind()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name='skytorch-http')
        self._http_thread.start()
        return self.port

    def run_forever(self) -> None:
        """Standalone mode: serve until stopped; SIGTERM drains first (a
        signal handler can only be installed from the main thread)."""
        self._bind()
        try:
            signal.signal(signal.SIGTERM,
                          lambda *_: self.begin_drain('sigterm'))
        except ValueError:
            pass
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        """Stop the engine loop (waiting ``SKYTPU_SERVER_STOP_TIMEOUT_
        SECONDS`` for it) and the HTTP server; idempotent."""
        self._stop.set()
        stop_timeout = env.env_float(STOP_TIMEOUT_ENV,
                                     DEFAULT_STOP_TIMEOUT_SECONDS)
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=stop_timeout)
            if self._engine_thread.is_alive():
                logger.error('engine thread did not stop within %.0fs: '
                             'wedged (it still holds the device)',
                             stop_timeout)
                journal.event(
                    journal.EventKind.ENGINE_CRASH,
                    f'engine:{self.engine.name}',
                    {'error': 'engine thread wedged at server stop',
                     'wedged': True, 'phase': 'stop',
                     'join_timeout_seconds': stop_timeout},
                    db_path=self._journal_db)
        if self._httpd is not None:
            if self._serving:
                # Returns once serve_forever has (on whatever thread).
                self._httpd.shutdown()
                self._serving = False
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        self._set_state('stopped')

    def _set_state(self, state: str) -> None:
        self._state = state
        metrics_lib.gauge(
            'skytpu_server_state',
            'Model server lifecycle state (0=running, 1=draining, '
            '2=stopped).').set(_STATE_VALUES.get(state, 0))

    def _entity(self) -> str:
        return f'server:{self.engine.name}:{self.port}'

    def begin_drain(self, reason: str = 'api') -> bool:
        """Flip to draining (False when not running): /healthz and new
        /generate calls answer 503, in-flight requests get up to
        ``drain_timeout`` seconds to finish, then the server stops."""
        with self._state_lock:
            if self._state != 'running':
                return False
            self._drains += 1
            self._set_state('draining')
        journal.event(journal.EventKind.SERVER_DRAIN, self._entity(),
                      {'phase': 'begin', 'reason': reason,
                       'in_flight': self.engine.active_slots(),
                       'queued': self.engine.queue_depth(),
                       'timeout_seconds': self.drain_timeout},
                      db_path=self._journal_db)
        logger.info('Draining (%s): waiting up to %.0fs for %d in-flight '
                    'and %d queued requests.', reason, self.drain_timeout,
                    self.engine.active_slots(), self.engine.queue_depth())
        self._drain_thread = threading.Thread(target=self._drain_and_stop,
                                              daemon=True,
                                              name='skytorch-drain')
        self._drain_thread.start()
        return True

    def _drain_and_stop(self) -> None:
        t0 = time.time()
        deadline = t0 + self.drain_timeout
        drained = False
        while time.time() < deadline:
            # drain_hang (chaos): never see the engine idle, so the
            # drain rides out its timeout.
            if self.engine.idle() and not chaos.armed('drain_hang'):
                drained = True
                break
            time.sleep(0.05)
        journal.event(journal.EventKind.SERVER_DRAIN, self._entity(),
                      {'phase': 'done', 'drained': drained,
                       'waited_seconds': round(time.time() - t0, 3),
                       'in_flight': self.engine.active_slots(),
                       'queued': self.engine.queue_depth()},
                      db_path=self._journal_db)
        if not drained:
            logger.warning('Drain timed out after %.0fs with %d request(s) '
                           'in flight; stopping anyway.',
                           self.drain_timeout, self.engine.active_slots())
        self.stop()

    # ----------------------------------------------------------- handlers

    def staleness_seconds(self) -> float:
        """Age of the engine loop's heartbeat, floored at the server's
        start so an engine that has not beaten yet reads fresh."""
        beat = max(self.engine.profiler.heartbeat_ts(),
                   self._started_at or 0.0)
        return max(0.0, time.time() - beat)

    def health(self):
        """The reference's /healthz order: failed for good, not running,
        engine thread dead, stale, ok."""
        alive = (self._engine_thread is not None and
                 self._engine_thread.is_alive())
        staleness = self.staleness_seconds()
        line = ' '.join([f'role={self.role}'] +
                        [f'{k}={v}' for k, v in self.engine.stats().items()])
        tail = f'staleness_seconds={staleness:.3f} {line}\n'
        if self.engine.failed:
            return 503, (f'engine failed permanently '
                         f'({self.engine.fail_reason}) {tail}')
        if self._state != 'running':
            return 503, f'{self._state} {tail}'
        if not alive:
            return 503, f'engine thread dead {tail}'
        if (self.max_staleness is not None and
                staleness > self.max_staleness):
            return 503, f'stale {tail}'
        return 200, f'ok {tail}'

    def slo(self) -> dict:
        """The ``/slo`` body: the request-telemetry SLO surface plus the
        reference's resilience, spec, cache, role, handoff, store and
        step-profile blocks."""
        body = self.engine.telemetry.slo()
        body['resilience'] = {
            'server_state': self._state,
            'drains_total': self._drains,
            'engine_restarts': self.engine.restart_count(),
            'engine_failed': self.engine.failed,
        }
        body['spec'] = self.engine.spec_stats()
        body['cache'] = self.engine.cache_stats()
        body['role'] = self.role
        body['handoff'] = self.engine.handoff_stats()
        body['store'] = {
            'hosting': self.store is not None,
            'configured_url': self.engine.store_url,
            'in_backoff': (self.engine.store_in_backoff()
                           if self.engine.store_url else False),
            'prewarms': self._prewarms,
            'prewarm_tokens': self._prewarm_tokens,
        }
        if self.store is not None:
            body['store']['stats'] = self.store.stats()
        # Aggregates only, recomputed per call (heartbeat age included).
        steps = self.engine.profiler.snapshot(last_n=0)
        steps.pop('recent', None)
        body['steps'] = steps
        return body

    def handle_journal(self, h: '_Handler', body: dict) -> None:
        """Serve filtered rows of this replica's journal
        (``journal.serve_query``: trace id, kinds, entity, since-rowid
        cursor, hard row cap), after landing the engine's buffered rows.
        404 unless the replica has prefix peers or
        ``SKYTPU_JOURNAL_PEERS`` is set."""
        if (not self.engine.prefix_peers and
                not os.environ.get(JOURNAL_PEERS_ENV, '').strip()):
            h.send_json(404, {'error': 'journal query plane not '
                                       'configured (SKYTPU_JOURNAL_PEERS)'})
            return
        params = {**h.query(), **body}
        self.engine.flush_journal()
        out = journal.serve_query(params, db_path=self._journal_db,
                                  host=self._entity())
        out['role'] = self.role
        h.send_json(200, out)

    def handle_prefix_blocks(self, h: '_Handler') -> None:
        """The owner side of the prefix fetch: a peer whose radix cache
        missed posts the block-aligned prompt prefix; the engine loop
        matches it, and the reply carries the matched blocks past
        ``from_tokens``, dtype for dtype. Only a replica configured into
        the tier (prefix peers) exports: its tenants' cached KV must not
        go to whoever reaches its port. Within the tier the port is the
        trust domain of /generate.

        A store-hosting server answers from disk instead
        (:func:`block_store.handle_store_post`): spills persist, pre-warm
        bodies get a family's longest run, fetches the longest stored
        prefix. The decode and encode run on this request's own handler
        thread, never on the engine loop or the accept loop."""
        if self.store is not None:
            try:
                length = int(h.headers.get('Content-Length') or 0)
                body = json.loads(h.rfile.read(length))
            except (ValueError, UnicodeDecodeError):
                h.send_json(400, {'error': 'invalid JSON body'})
                return
            status, reply = block_store.handle_store_post(self.store, body)
            del body
            try:
                h.send_json(status, reply)
            except (BrokenPipeError, ConnectionResetError):
                logger.info('store client went away before its reply')
            return
        if not self.engine.paged:
            h.send_json(400, {'error': 'replica is not paged'})
            return
        if not self.engine.prefix_peers:
            h.send_json(404, {'error': 'prefix tier not configured '
                                       '(SKYTPU_PREFIX_PEERS)'})
            return
        try:
            length = int(h.headers.get('Content-Length') or 0)
            body = json.loads(h.rfile.read(length))
            tokens = [int(t) for t in body['prompt']]
            from_tokens = int(body.get('from_tokens', 0))
            budget = float(body.get('budget_seconds', 2.0))
            instance = body.get('instance')
        except (ValueError, UnicodeDecodeError, KeyError, TypeError,
                AttributeError):
            h.send_json(400, {'error': 'body needs "prompt" (token ids) '
                                       'and optional "from_tokens"'})
            return
        try:
            if instance and instance == self.engine.instance_id:
                # The caller is this engine (a fleet-shared peers list):
                # answer at once; it excludes this URL for good.
                h.send_json(200, {'self': True})
                return
            # The export wait honours the fetcher's read window (about
            # half its budget): past that nobody reads the reply.
            result = self.engine.export_prefix_blocks(
                tokens, from_tokens, min(2.0, max(budget / 2, 0.05)))
            if result is None:
                # Nothing cached past from_tokens: an honest empty
                # match, which does not back this replica off.
                h.send_json(200, prefix_transfer.empty_payload(
                    from_tokens, self.engine.dcfg.kernel_block_k,
                    self.engine.dcfg.kv_cache_dtype))
                return
            h.send_json(200, prefix_transfer.encode_payload(
                result['matched_tokens'], result['from_tokens'],
                result['block_k'], result['kv_cache_dtype'],
                result['arrays']))
        except (BrokenPipeError, ConnectionResetError):
            logger.info('prefix fetcher went away before its reply')

    def handle_store_stats(self, h: '_Handler') -> None:
        """``GET /prefix_blocks``: the hosted store's occupancy and hit
        counters; 404 when this server hosts no store."""
        if self.store is None:
            h.send_json(404, {'error': 'no block store hosted here'})
            return
        h.send_json(200, self.store.stats())

    def handle_prewarm(self, h: '_Handler') -> None:
        """``POST /prewarm``, the replica side of a store-warmed scale-up:
        pull each posted digest family's longest run from the configured
        store and install it through the handoff injection, so the first
        request of the family admits as a prefix hit.

        The body carries digests only: the store URL is this replica's
        own configuration, never the request's, so whoever reaches the
        port cannot point it at a poisoned store. A failed digest counts
        as missed; prewarm is best effort and never answers 500."""
        if not self.engine.paged:
            h.send_json(400, {'ok': False, 'error': 'replica is not paged'})
            return
        if not self.engine.store_url:
            h.send_json(404, {'ok': False,
                              'error': 'no durable store configured '
                                       '(SKYTPU_STORE_URL)'})
            return
        if self._state != 'running':
            h.send_json(503, {'ok': False, 'error': f'server {self._state}'},
                        headers={'Retry-After': '1'})
            return
        try:
            length = int(h.headers.get('Content-Length') or 0)
            body = json.loads(h.rfile.read(length))
            digests = [str(d) for d in body['digests']]
        except (ValueError, UnicodeDecodeError, KeyError, TypeError):
            h.send_json(400, {'ok': False,
                              'error': 'body needs "digests" (list)'})
            return
        max_digests = env.env_int(PREWARM_MAX_DIGESTS_ENV,
                                  DEFAULT_PREWARM_MAX_DIGESTS)
        budget = env.env_float(PREWARM_BUDGET_ENV,
                               DEFAULT_PREWARM_BUDGET_SECONDS)
        digests = digests[:max(0, max_digests)]
        warmed = missed = tokens_gained = 0
        for digest in digests:
            got = block_store.http_store_prewarm_fetch(
                self.engine.store_url, digest, budget)
            if got is None:
                missed += 1
                continue
            tokens, payload = got
            try:
                res = self.engine.inject_handoff_blocks(tokens, payload)
            except chaos.ChaosError:
                res = {'ok': False}
            if res.get('ok'):
                warmed += 1
                tokens_gained += int(res.get('gained', 0))
            else:
                missed += 1
        with self._prewarm_lock:
            self._prewarms += 1
            self._prewarm_tokens += tokens_gained
        metrics_lib.counter(
            'skytpu_prewarm_requests_total',
            'POST /prewarm requests served (store-warmed '
            'scale-up).').inc()
        metrics_lib.counter(
            'skytpu_prewarm_tokens_total',
            'Prefix tokens installed from the durable store by '
            '/prewarm.').inc(tokens_gained)
        journal.event(journal.EventKind.AUTOSCALE_PREWARM, self._entity(),
                      {'digests': digests, 'warmed': warmed,
                       'missed': missed, 'tokens': tokens_gained,
                       'store': self.engine.store_url},
                      db_path=self._journal_db)
        h.send_json(200, {'ok': True, 'warmed': warmed, 'missed': missed,
                          'tokens': tokens_gained})

    def handle_handoff_blocks(self, h: '_Handler') -> None:
        """The decode side of the handoff: a prefill peer posts one
        chunk's blocks of a request it is still prefilling (the wire
        format plus ``prompt``); the engine loop installs them into the
        pool and the radix cache, so the request sent here next admits as
        a near-full prefix hit. The refusals are ``/prefix_blocks``'s,
        plus 503 unless running: a draining replica must send the prefill
        side into its degrade path rather than accept blocks it is about
        to drop."""
        if not self.engine.paged:
            h.send_json(400, {'ok': False, 'error': 'replica is not paged'})
            return
        if not self.engine.prefix_peers:
            # The trust rule of /prefix_blocks: a replica outside the
            # tier accepts no KV from whoever reaches its port.
            h.send_json(404, {'ok': False,
                              'error': 'handoff tier not configured '
                                       '(SKYTPU_PREFIX_PEERS)'})
            return
        if self._state != 'running':
            h.send_json(503, {'ok': False,
                              'error': f'server {self._state}'},
                        headers={'Retry-After': '1'})
            return
        try:
            length = int(h.headers.get('Content-Length') or 0)
            body = json.loads(h.rfile.read(length))
            tokens = [int(t) for t in body['prompt']]
        except (ValueError, UnicodeDecodeError, KeyError, TypeError):
            h.send_json(400, {'ok': False, 'error': 'malformed body'})
            return
        payload = prefix_transfer.decode_payload(body)
        del body
        if payload is None:
            h.send_json(400, {'ok': False, 'error': 'malformed payload'})
            return
        try:
            result = self.engine.inject_handoff_blocks(tokens, payload)
        except chaos.ChaosError as e:
            # handoff_decode_death: a 500 mid-handoff sends the prefill
            # side into its degrade path, as a real peer death would.
            h.send_json(500, {'ok': False, 'error': str(e)})
            return
        h.send_json(200, result)

    def parse_prompt_body(self, body):
        """``(tokens, max_new, None)`` or ``(None, 0, (status, error))``,
        the reference's validation."""
        vocab = self.engine.cfg.vocab_size
        if not isinstance(body, dict):
            return None, 0, (400, 'body must be a JSON object')
        if 'prompt' in body:
            try:
                tokens = [int(t) % vocab for t in body['prompt']]
            except (TypeError, ValueError):
                return None, 0, (400, 'prompt must be a list of token ids')
        elif 'text' in body and isinstance(body['text'], str):
            tokens = encode_text(body['text'], vocab)
        else:
            return None, 0, (400,
                             'body needs "prompt" (token ids) or "text"')
        if not tokens:
            return None, 0, (400, 'empty prompt')
        try:
            max_new = int(body.get('max_new_tokens',
                                   self.default_max_new_tokens))
        except (TypeError, ValueError):
            return None, 0, (400, 'max_new_tokens must be an integer')
        limit = self.engine.dcfg.max_len - len(tokens)
        if limit < 1:
            return None, 0, (400, f'prompt too long: {len(tokens)} tokens, '
                                  f'max_len {self.engine.dcfg.max_len}')
        return tokens, max(1, min(max_new, limit)), None

    @staticmethod
    def push_budget() -> float:
        """Seconds one handoff push may take (``SKYTPU_HANDOFF_PUSH_BUDGET_
        SECONDS``, read per request as the reference reads it)."""
        return env.env_float(prefix_transfer.PUSH_BUDGET_ENV,
                             prefix_transfer.DEFAULT_PUSH_BUDGET_SECONDS)

    def _handoff_target(self, h: '_Handler') -> tuple:
        """``(target, peer, degrade reason or None)`` of a
        ``/prefill_handoff``. The header only selects within the
        configured peers: pushing a tenant's KV to a URL a client named
        would exfiltrate its prompt. The peer entry, not the header, keys
        the engine's backoff, which the fetch direction shares."""
        target = (h.headers.get(trace_lib.HANDOFF_TARGET_HEADER)
                  or '').strip().rstrip('/')
        peer = {u.rstrip('/'): u for u in self.engine.prefix_peers}.get(
            target)
        if not self.engine.paged:
            return target, peer, 'not_paged'
        if not target:
            return target, peer, 'no_target'
        if peer is None:
            return target, peer, 'untrusted_target'
        if self.engine.peer_in_backoff(peer):
            return target, peer, 'peer_backoff'
        return target, peer, None

    def handle_generate(self, h: _Handler, handoff: bool = False) -> None:
        """``/generate``, or with ``handoff`` the prefill leg
        ``/prefill_handoff``: the same body, checks and replies, with the
        request armed to push its blocks to the target decode replica
        (or degraded to a plain generate at admission)."""
        if not handoff and chaos.should_fire('replica_500'):
            h.send_json(500, {'error': 'chaos: injected replica_500'})
            return
        # Draining or stopped: answer at once, so the client retries
        # another replica instead of queueing behind one that will not
        # admit it.
        state = self._state
        if state != 'running':
            h.send_json(503, {'error': f'server {state}', 'state': state},
                        headers={'Retry-After': '1'})
            return
        if self.engine.failed:
            h.send_json(503, {'error': f'engine failed: '
                                       f'{self.engine.fail_reason}'},
                        headers={'Retry-After': '30'})
            return
        try:
            length = int(h.headers.get('Content-Length') or 0)
            body = json.loads(h.rfile.read(length))
        except (ValueError, UnicodeDecodeError):
            h.send_json(400, {'error': 'invalid JSON body'})
            return
        tokens, max_new, err = self.parse_prompt_body(body)
        if err is not None:
            h.send_json(err[0], {'error': err[1]})
            return
        stream = bool(body.get('stream', True))
        # Backpressure before enqueueing (0 disables).
        if self.max_queue > 0:
            depth = self.engine.queue_depth()
            if depth >= self.max_queue:
                metrics_lib.counter(
                    'skytpu_server_rejected_total',
                    'Requests rejected with 429 (queue full).').inc()
                h.send_json(429, {'error': f'queue full ({depth} waiting)'},
                            headers={'Retry-After': '1'})
                return
        degrade = peer = target = None
        if handoff:
            target, peer, degrade = self._handoff_target(h)
            if degrade is not None:
                # Counted and journaled here: the engine never sees a
                # handoff it cannot arm; the request is a plain generate.
                metrics_lib.counter(
                    'skytpu_engine_handoffs_total',
                    'Full-request KV handoff attempts by outcome.',
                    labels=('result',)).inc(labels=('degraded',))
                journal.event(journal.EventKind.ENGINE_HANDOFF,
                              self._entity(),
                              {'outcome': 'degraded', 'reason': degrade,
                               'target': target or None},
                              db_path=self._journal_db)
        tenant = h.headers.get('X-Tenant') or body.get('tenant') or 'default'
        # The client's X-Request-Id, else a minted trace id, is the
        # request's trace id; a load balancer's hop headers join its
        # trace and parent this server.request span under its own.
        request_id = (h.headers.get(trace_lib.REQUEST_ID_HEADER)
                      or trace_lib.new_trace_id())
        trace_id = h.headers.get(trace_lib.TRACE_ID_HEADER) or request_id
        parent_span = h.headers.get(trace_lib.SPAN_ID_HEADER)
        span_id = trace_lib.new_span_id()
        events: queue.Queue = queue.Queue()
        # The header value rides as the trace id only: engine request
        # ids stay server-generated and unique.
        req = engine_lib.Request(
            tokens, max_new, tenant=str(tenant),
            on_token=lambda token, done: events.put((token, done)),
            trace_id=trace_id, span_id=span_id,
            prefix_hint=(None if handoff else
                         h.headers.get(trace_lib.PREFIX_OWNER_HEADER)))
        # Terminal sentinel: a rejected request finishes without a token.
        req.on_finish = lambda: events.put((None, True))
        rid = {'X-Request-Id': req.trace_id or req.id}
        if handoff and degrade is None:
            req.handoff_peer = peer
            req.handoff_push = functools.partial(
                prefix_transfer.http_push, peer,
                budget_seconds=self.push_budget(),
                instance=self.engine.instance_id)
        # The span rows ride the engine's batched journal buffer (one
        # transaction per engine tick), not a commit per request.
        span = 'server.handoff' if handoff else 'server.request'
        start = ({'target': target or None,
                  'degraded_at_admission': degrade} if handoff
                 else {'stream': stream})
        self.engine.journal_buffered(
            journal.EventKind.SPAN_START,
            {'name': span, 'request': req.id, 'tenant': req.tenant,
             'prompt_len': len(tokens), **start},
            trace_id=trace_id, span_id=span_id,
            parent_span_id=parent_span, entity=self._entity())
        self.engine.submit(req)
        metrics_lib.counter('skytpu_engine_requests_total',
                            'HTTP /generate requests accepted.',
                            labels=('stream',)).inc(
                                labels=(str(stream).lower(),))
        try:
            first = None
            if handoff:
                try:
                    first = events.get(timeout=self.request_timeout)
                except queue.Empty:
                    h.send_json(504, {'error': 'timeout'}, headers=rid)
                    return
                if first[0] is None and req.finish_reason == 'handoff':
                    # Every full block acked: the decode replica owns the
                    # stream, and this replica's blocks are back in its
                    # pool.
                    h.send_json(200, {'handoff': 'complete',
                                      'decode_url': peer,
                                      'prompt_len': len(tokens),
                                      'max_new_tokens': max_new},
                                headers={'X-Skytpu-Handoff': 'complete',
                                         **rid})
                    return
                rid['X-Skytpu-Handoff'] = 'degraded'
            if stream:
                self._stream_response(h, req, events, rid, first)
            else:
                self._unary_response(h, req, events, rid, first)
        except (BrokenPipeError, ConnectionResetError):
            logger.info('client of request %s went away', req.id)
        finally:
            self.engine.journal_buffered(
                journal.EventKind.SPAN_END,
                {'name': span,
                 'finish_reason': req.finish_reason,
                 'generated': len(req.tokens)},
                trace_id=trace_id, span_id=span_id,
                parent_span_id=parent_span, entity=self._entity())

    @staticmethod
    def _next_event(events: queue.Queue, first, timeout: float):
        """``first`` (an event the caller already took off the queue to
        choose the reply's shape) once, then the queue's."""
        if first is not None:
            return first
        return events.get(timeout=timeout)

    def _stream_response(self, h: _Handler, req: engine_lib.Request,
                         events: queue.Queue, rid: dict,
                         first=None) -> None:
        h.send_response(200)
        h.send_header('Content-Type', 'text/event-stream')
        h.send_header('Cache-Control', 'no-cache')
        for k, v in rid.items():
            h.send_header(k, v)
        h.end_headers()

        def write(event: dict) -> None:
            h.wfile.write(f'data: {json.dumps(event)}\n\n'.encode())
            h.wfile.flush()

        while True:
            try:
                token, done = self._next_event(events, first,
                                               self.request_timeout)
            except queue.Empty:
                write({'error': 'timeout'})
                return
            first = None
            if token is None:
                # Terminal with no token: engine-side rejection/error.
                write({'error': req.finish_reason, 'done': True})
                return
            event = {'token': token, 'text': decode_tokens([token]),
                     'done': done}
            if done:
                event['finish_reason'] = req.finish_reason
                event['generated'] = len(req.tokens)
            write(event)
            if done:
                return

    def _unary_response(self, h: _Handler, req: engine_lib.Request,
                        events: queue.Queue, rid: dict,
                        first=None) -> None:
        token = None
        try:
            while True:
                token, done = self._next_event(events, first,
                                               self.request_timeout)
                first = None
                if done:
                    break
        except queue.Empty:
            h.send_json(504, {'error': 'timeout'}, headers=rid)
            return
        finish = req.finish_reason or ''
        if token is None and not req.tokens:
            # Rejection is the client's fault (422); an engine failure
            # is ours (500).
            status = 422 if finish.startswith('rejected') else 500
            h.send_json(status, {'error': finish}, headers=rid)
            return
        if finish.startswith('error'):
            h.send_json(500, {'error': finish, 'tokens': req.tokens,
                              'generated': len(req.tokens)}, headers=rid)
            return
        h.send_json(200, {'tokens': req.tokens,
                          'text': decode_tokens(req.tokens),
                          'finish_reason': finish,
                          'generated': len(req.tokens)}, headers=rid)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='Continuous-batching model server (PyTorch/CUDA).')
    parser.add_argument('--port', type=int,
                        default=int(os.environ.get(REPLICA_PORT_ENV,
                                                   '8000')))
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--model', default='debug',
                        choices=sorted(llama.CONFIGS))
    parser.add_argument('--num-slots', type=int, default=8,
                        help='KV-cache lanes (continuous batch width)')
    parser.add_argument('--max-len', type=int, default=2048,
                        help='per-slot KV capacity (prompt + generation)')
    parser.add_argument('--max-new-tokens', type=int, default=128,
                        help='default generation budget per request')
    parser.add_argument('--step-chunk', type=int, default=4,
                        help='decode steps per engine tick (one host '
                             'fetch per tick)')
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--eos-id', type=int, default=None)
    parser.add_argument('--int8', action='store_true',
                        help='int8-quantize the GEMM weights')
    parser.add_argument('--kv-int8', action='store_true',
                        help='int8 KV cache')
    parser.add_argument('--attn', choices=('kernel', 'plain'),
                        default='kernel',
                        help="cached attention: the CUDA kernels or the "
                             "plain PyTorch path")
    parser.add_argument('--paged', action='store_true',
                        help='paged KV cache + radix prefix reuse')
    parser.add_argument('--num-blocks', type=int, default=None,
                        help='paged pool size in blocks (default: the '
                             'dense cache equivalent + 1 scratch)')
    parser.add_argument('--block-k', type=int, default=None,
                        help='paged pool block size in tokens '
                             '(default 128)')
    parser.add_argument('--spec-k', type=int, default=None,
                        help='speculative decoding: draft tokens per '
                             'engine step (paged + greedy only; default '
                             'SKYTPU_SPEC_K or 0 = off)')
    parser.add_argument('--drafter-layers', type=int, default=None,
                        help='truncated-layer drafter depth (default '
                             'SKYTPU_SPEC_DRAFTER_LAYERS or 1)')
    parser.add_argument('--prefill-chunk', type=int, default=None,
                        help='chunked prefill: paged admissions whose '
                             'uncached suffix exceeds this many tokens '
                             'prefill one chunk per engine step (default '
                             'SKYTPU_PREFILL_CHUNK or 0 = off)')
    parser.add_argument('--prefix-peers', default=None,
                        help='comma-separated peer replica URLs for the '
                             'cross-replica prefix cache tier: on a '
                             'local radix miss the engine pulls cached '
                             'KV prefix blocks from a peer (or the '
                             'LB-advertised owner) instead of '
                             're-prefilling (default SKYTPU_PREFIX_PEERS '
                             'or disabled)')
    parser.add_argument('--role', choices=_ROLES, default=None,
                        help='serving role (default SKYTPU_REPLICA_ROLE or '
                             'mixed): prefill replicas hand requests off '
                             'to a decode peer after prefill; decode '
                             'replicas adopt them; mixed serves '
                             'monolithically; store hosts the durable '
                             'block store (with --store-dir or '
                             'SKYTPU_STORE_DIR)')
    parser.add_argument('--store-url', default=None,
                        help='durable block-store URL: the second level '
                             'of the cold-miss prefix lookup (peers first, '
                             'store second) and the write-behind spill '
                             'target of published radix runs (default '
                             'SKYTPU_STORE_URL or disabled; paged only)')
    parser.add_argument('--store-dir', default=None,
                        help='host the durable block store from this '
                             'directory: /prefix_blocks answers spills, '
                             'fetches and pre-warm lookups from disk '
                             '(default SKYTPU_STORE_DIR when --role '
                             'store)')
    parser.add_argument('--checkpoint-dir', default=None,
                        help='restore params from models/checkpoint '
                             'save_params layout (default: random init)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda; a machine '
                             'without a card needs --device cpu)')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel degree: shard the weights '
                             'and the paged KV pool over this many ranks, '
                             'one card each over NCCL (requires --paged; '
                             'default SKYTPU_SERVE_TP or 1 = unsharded; '
                             'under a gang every process is a rank)')
    return parser.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    # A gang: join its process group before the first device access;
    # every process is a rank of one TP replica, so each checks the
    # degree before process 0 serves and the others run the TP worker
    # loop. No-op elsewhere.
    platform = 'cpu' if args.device == 'cpu' else 'cuda'
    if distributed.maybe_initialize('gloo' if platform == 'cpu' else None):
        tp, world = serve_tp(args.tp), torch.distributed.get_world_size()
        if tp != world:
            raise ValueError(
                f'a gang of {world} processes serves one replica at '
                f'tp={world} (--tp or {SERVE_TP_ENV}), got tp={tp}; '
                f'{distributed.DISABLE_ENV}=1 serves a replica a process')
        if distributed.process_index():
            tp_lib.serve_gang(platform)
            return
    engine = build_engine(args.model, args.num_slots, args.max_len,
                          temperature=args.temperature, eos_id=args.eos_id,
                          kv_int8=args.kv_int8, int8=args.int8,
                          attn=args.attn, step_chunk=args.step_chunk,
                          checkpoint_dir=args.checkpoint_dir, seed=args.seed,
                          paged=args.paged, num_blocks=args.num_blocks,
                          block_k=args.block_k, spec_k=args.spec_k,
                          drafter_layers=args.drafter_layers,
                          prefill_chunk=args.prefill_chunk,
                          prefix_peers=(
                              [u.strip()
                               for u in args.prefix_peers.split(',')
                               if u.strip()]
                              if args.prefix_peers else None),
                          store_url=args.store_url, device=args.device,
                          tp=args.tp)
    store = (block_store.BlockStore(args.store_dir)
             if args.store_dir else None)
    try:
        ModelServer(engine, args.port, host=args.host,
                    default_max_new_tokens=args.max_new_tokens,
                    role=args.role, store=store).run_forever()
    finally:
        engine.close()


if __name__ == '__main__':
    main()
