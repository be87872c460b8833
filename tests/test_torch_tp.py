"""Tensor-parallel serving on the port (skypilot_tpu_torch/parallel/,
models/engine.py ``tp=``) held against the reference's
tests/unit_tests/test_tp_engine.py, case for case, on the CPU.

One module-scoped gloo group of two CPU ranks (this process and one
worker process) carries every port engine of the file; the reference
runs in process on the conftest's 8-device CPU mesh. Same params (the
reference's, bridged bit for bit), same prompts and budgets:

* **Greedy token parity**: port tp=2 == reference tp=1 == reference tp=2
  on the paged path with bf16 and int8 K/V, speculative decoding with
  bf16 and int8 K/V (both sides draft and reject), int8 weights, and
  chunked prefill with speculation; and == the reference's static
  ``generate``.
* **Sharding**: every rank's pool and scale planes hold ``Hkv / tp``
  heads; wq/wk are column slices, wo row slices, and an int8 ``wo``'s
  scale stays whole; a supervisor restart re-shards every rank; export
  payloads are unsharded.
* **Observability**: ``engine.mesh`` journaled once with the reference's
  keys, the TP gauges.
* **Validation** and **wiring**: the reference's four errors, the
  backend refusals, ``build_engine``'s env and argument,
  ``distributed_env`` and ``maybe_initialize``, and a killed worker
  failing rank 0 instead of hanging it.

The card case (``cuda`` marker) runs on a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_tp.py``; this
file imports JAX only inside the cases that run the reference.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as tengine
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.observability import journal as tjournal
from skypilot_tpu_torch.observability import metrics as tmetrics
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh
from skypilot_tpu_torch.parallel import tp as tp_lib
from skypilot_tpu_torch.serve import model_server

torch.set_num_threads(2)

CFG = tllama.CONFIGS['debug']
MAX_NEWS = (4, 8, 3, 6, 8)


def _prompts(seed=3, prefix_len=16, extras=(3, 7, 0, 5, 9)):
    """The reference test's prompts: a shared 16-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG.vocab_size, size=prefix_len).tolist()
    return [shared + rng.randint(0, CFG.vocab_size, size=int(e)).tolist()
            for e in extras]


@pytest.fixture(scope='module')
def group():
    """The file's two-rank gloo group. Module-scoped, so its worker starts
    before any case's isolated HOME (the harness reaps a case's processes
    by their HOME when the case ends)."""
    g = tp_lib.local_group(2, platform='cpu')
    yield g
    g.close()


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = tmetrics.set_registry(tmetrics.MetricsRegistry())
    yield
    tmetrics.set_registry(prev)


@pytest.fixture(scope='module')
def params():
    """(reference params, the port's bridge of them)."""
    import jax  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS['debug'])
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


def _dcfg(kv_dtype='bf16', spec_k=0, attn='plain'):
    return tdecode.DecodeConfig(max_len=64, kv_cache_dtype=kv_dtype,
                                decode_attention=attn, kernel_block_k=8,
                                spec_k=spec_k, spec_drafter_layers=1)


def _engine(tparams, dcfg, group=None, prefill_chunk=0, **kw):
    """The reference test's engine; tp=2 on ``group``, else tp=1."""
    return tengine.DecodeEngine(
        tparams, CFG, dcfg, 2, step_chunk=2, prefill_buckets=(16, 32),
        paged=True, num_blocks=40, prefill_chunk=prefill_chunk,
        tp=group.size if group else 1, tp_group=group, **kw)


def _drain(eng, reqs, max_steps=500):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, 'engine did not converge'


def _run(eng):
    reqs = [tengine.Request(p, m) for p, m in zip(_prompts(), MAX_NEWS)]
    _drain(eng, reqs)
    return [r.tokens for r in reqs]


_REF_RUNS = {}


def _reference(jparams, kv_dtype, spec_k, tp, int8=False, prefill_chunk=0):
    """The reference engine's tokens and spec stats (cached per case)."""
    key = (kv_dtype, spec_k, tp, int8, prefill_chunk)
    if key not in _REF_RUNS:
        from skypilot_tpu.models import decode as jdecode  # pylint: disable=import-outside-toplevel
        from skypilot_tpu.models import engine as jengine  # pylint: disable=import-outside-toplevel
        from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
        from skypilot_tpu.observability import metrics as rmetrics  # pylint: disable=import-outside-toplevel
        prev = rmetrics.set_registry(rmetrics.MetricsRegistry())
        try:
            p = jdecode.quantize_params(jparams) if int8 else jparams
            dcfg = jdecode.DecodeConfig(
                max_len=64, kv_cache_dtype=kv_dtype, decode_attention='xla',
                kernel_block_k=8, spec_k=spec_k, spec_drafter_layers=1)
            eng = jengine.DecodeEngine(
                p, jllama.CONFIGS['debug'], dcfg, 2, step_chunk=2,
                prefill_buckets=(16, 32), paged=True, num_blocks=40,
                prefill_chunk=prefill_chunk, tp=tp, name='ref-tp')
            reqs = [jengine.Request(pr, m)
                    for pr, m in zip(_prompts(), MAX_NEWS)]
            _drain(eng, reqs)
            _REF_RUNS[key] = ([r.tokens for r in reqs], eng.stats())
        finally:
            rmetrics.set_registry(prev)
    return _REF_RUNS[key]


# ------------------------------------------------------------- parity

PARITY = {
    'paged-bf16': dict(kv_dtype='bf16'),
    'paged-int8': dict(kv_dtype='int8'),
    'spec-bf16': dict(kv_dtype='bf16', spec_k=3),
    'spec-int8': dict(kv_dtype='int8', spec_k=3),
    'int8-weights': dict(kv_dtype='bf16', int8=True),
    'chunked-spec': dict(kv_dtype='bf16', spec_k=3, prefill_chunk=4),
}


@pytest.mark.parametrize('case', sorted(PARITY))
def test_tp2_matches_reference_tp1_and_tp2(params, group, case):
    """Port tp=2 greedy tokens equal the reference's at tp=1 and at tp=2:
    sharding stays a layout, never a numerics fork. Speculative cases
    draft and reject on both sides, so the rollback ran sharded; the
    chunked case resumed chunks into the sharded pool."""
    kw = dict(PARITY[case])
    kv, spec_k = kw['kv_dtype'], kw.get('spec_k', 0)
    int8, chunk = kw.get('int8', False), kw.get('prefill_chunk', 0)
    jp, tp_params = params
    ref1, st1 = _reference(jp, kv, spec_k, 1, int8, chunk)
    ref2, _ = _reference(jp, kv, spec_k, 2, int8, chunk)
    assert ref1 == ref2
    p = tdecode.quantize_params(tp_params) if int8 else tp_params
    eng = _engine(p, _dcfg(kv, spec_k), group, prefill_chunk=chunk)
    try:
        assert _run(eng) == ref1
        st = eng.stats()
        assert eng.tp == 2 and st['tp'] == 2
        if spec_k:
            for s in (st, st1):
                assert 0 < s['spec_accepted'] < s['spec_drafted']
        if chunk:
            assert st['prefill_chunks'] > 0
    finally:
        eng.close()


def test_tp2_matches_static_generate(params, group):
    """Transitivity made explicit: the port's tp=2 engine matches the
    reference's static ``decode.generate``."""
    import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import decode as jdecode  # pylint: disable=import-outside-toplevel
    from skypilot_tpu.models import llama as jllama  # pylint: disable=import-outside-toplevel
    jp, tp_params = params
    prompts = _prompts()
    s = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    static = np.asarray(jdecode.generate(
        jp, jnp.asarray(batch), jnp.asarray(lens), jllama.CONFIGS['debug'],
        jdecode.DecodeConfig(max_len=64, decode_attention='xla',
                             kernel_block_k=8), 8))
    eng = _engine(tp_params, _dcfg(), group)
    try:
        for i, toks in enumerate(_run(eng)):
            assert toks == static[i, :MAX_NEWS[i]].tolist(), i
    finally:
        eng.close()


# ----------------------------------------------------------- sharding


def _pool_shapes(eng):
    return [r['pool_shapes'] for r in eng.rank_stats()]


def test_pool_and_params_sharded_by_kv_head(params, group):
    """Every rank's pool holds [L, n_blocks, block_k, Hkv/tp, hd] and its
    scale planes [L, n_blocks, block_k, Hkv/tp]; wk's columns and wo's
    rows split; the block tables stay whole on rank 0's host."""
    eng = _engine(params[1], _dcfg('int8'), group)
    try:
        _run(eng)
        hkv = CFG.n_kv_heads // 2
        full = (CFG.n_layers, 40, 8, hkv, CFG.head_dim)
        want = {'k': full, 'v': full, 'k_scale': full[:-1],
                'v_scale': full[:-1]}
        assert _pool_shapes(eng) == [want, want]
        assert eng._block_table_np.shape == (2, 8)  # pylint: disable=protected-access
        layers = eng.params['layers']
        assert layers['wk'].shape[-1] == CFG.n_kv_heads * CFG.head_dim // 2
        assert layers['wq'].shape[-1] == CFG.n_heads * CFG.head_dim // 2
        assert isinstance(layers['wo'], mesh.RowParallel)
        assert layers['wo'].local.shape[1] == CFG.dim // 2
        assert isinstance(eng.params['lm_head'], mesh.VocabParallel)
        assert eng.params['lm_head'].local.shape[1] == CFG.vocab_size // 2
        assert eng.params['tok_embedding'].shape == (CFG.vocab_size,
                                                     CFG.dim)
    finally:
        eng.close()


def test_int8_weight_shards_keep_row_parallel_scales_whole(params, group):
    """Column-parallel scales split with their output channels; the
    row-parallel wo/w2 values split their contraction rows and their
    [L, 1, out] scale planes stay whole (the reference's size-1 rule);
    every slice is contiguous (int8 values K-major)."""
    q = tdecode.quantize_params(params[1])
    eng = _engine(q, _dcfg(), group)
    try:
        layers = eng.params['layers']
        wq = layers['wq']
        assert wq.scale.shape[-1] == q['layers']['wq'].scale.shape[-1] // 2
        assert wq.values.stride(1) == 1
        for name in ('wo', 'w2'):
            w = layers[name].local
            assert w.values.shape[1] == q['layers'][name].values.shape[1] // 2
            assert w.scale.shape == q['layers'][name].scale.shape
            assert torch.equal(w.scale, q['layers'][name].scale)
    finally:
        eng.close()


def test_restart_reshards_every_rank(params, group):
    """The supervisor's rebuild makes every rank's pool again at Hkv/tp
    heads, and the replica serves the reference's tokens after it."""
    jp, tp_params = params
    eng = _engine(tp_params, _dcfg(), group, name='t-tp-restart')
    try:
        _run(eng)
        assert eng._recover_from_crash(RuntimeError('injected')) is True  # pylint: disable=protected-access
        assert all(s['k'][3] == CFG.n_kv_heads // 2
                   for s in _pool_shapes(eng))
        assert _run(eng) == _reference(jp, 'bf16', 0, 1)[0]
        assert eng.stats()['restarts'] == 1
    finally:
        eng.close()


def test_export_payload_is_unsharded_and_injects_into_tp1(params, group):
    """A tp=2 engine's exported prefix is the unsharded [L, n, block_k,
    Hkv, hd] payload in the tp=1 engine's format (planes, shapes, dtypes,
    fields); layer 0, which no reduction reaches, is bit-equal to the
    tp=1 export, and the later layers differ at most by the rounding of
    the row-parallel sums. A tp=1 engine that installs it continues with
    the tokens it would have computed itself; the reverse injection
    scatters heads into every rank."""
    tp_params = params[1]
    for kv in ('bf16', 'int8'):
        prompt = _prompts()[0]
        e2 = _engine(tp_params, _dcfg(kv), group)
        e1 = _engine(tp_params, _dcfg(kv))
        try:
            for e in (e1, e2):
                _drain(e, [tengine.Request(prompt, 2)])
            p2 = e2._export_prefix_now(prompt)  # pylint: disable=protected-access
            p1 = e1._export_prefix_now(prompt)  # pylint: disable=protected-access
            assert p2['matched_tokens'] == p1['matched_tokens'] == 16
            assert {k: v for k, v in p2.items() if k != 'arrays'} == \
                {k: v for k, v in p1.items() if k != 'arrays'}
            assert sorted(p2['arrays']) == sorted(p1['arrays'])
            for name, a in p1['arrays'].items():
                b = p2['arrays'][name]
                assert (b.shape, b.dtype) == (a.shape, a.dtype)
                assert a.shape[3] == CFG.n_kv_heads
                assert torch.equal(b[0], a[0]), name
                tol = 2 if a.dtype == torch.int8 else 0.05
                assert (b.float() - a.float()).abs().max() <= tol, name
            # tp=2 blocks into a fresh tp=1 engine and tp=1 blocks into a
            # fresh tp=2 engine: both continue as a control does.
            for src, g in ((p2, None), (p1, group)):
                fresh = _engine(tp_params, _dcfg(kv), g)
                try:
                    got = fresh._install_remote_blocks(  # pylint: disable=protected-access
                        prompt, src, [], 0)
                    assert got == 16
                    req = tengine.Request(prompt, 6)
                    _drain(fresh, [req])
                    ctl = tengine.Request(prompt, 6)
                    _drain(_engine(tp_params, _dcfg(kv)), [ctl])
                    assert req.tokens == ctl.tokens
                    assert fresh.stats()['prefill_tokens_saved'] == 16
                finally:
                    fresh.close()
        finally:
            e2.close()


# ------------------------------------------------------ observability


def test_engine_mesh_journaled_with_topology(params, group, tmp_path):
    """engine.mesh once, with the reference's keys; the TP gauges."""
    db = str(tmp_path / 'j.db')
    eng = _engine(params[1], _dcfg(), group, name='t-tp-mesh',
                  journal_db=db)
    try:
        _run(eng)
        eng.flush_journal()
        rows = tjournal.query(kinds=[tjournal.EventKind.ENGINE_MESH],
                              entity='engine:t-tp-mesh', limit=10,
                              db_path=db)
        assert len(rows) == 1, 'engine.mesh must journal exactly once'
        payload = rows[0]['payload']
        assert sorted(payload) == ['device_kinds', 'devices', 'mesh_shape',
                                   'paged', 'platform', 'process_count',
                                   'tp']
        assert payload['tp'] == 2 and payload['mesh_shape'] == {'model': 2}
        assert payload['devices'] == 2 and payload['device_kinds'] == ['cpu']
        assert payload['platform'] == 'cpu'
        reg = tmetrics.get_registry()
        assert reg.get('skytpu_engine_tp_degree').value() == 2
        assert reg.get('skytpu_engine_mesh_devices').value() == 2
        hbm = tjournal.query(kinds=[tjournal.EventKind.ENGINE_HBM],
                             entity='engine:t-tp-mesh', db_path=db)
        weights = hbm[0]['payload']['per_device_bytes']['weights']
        assert weights < sum(t.nbytes for _, t in mesh.flatten(params[1]))
    finally:
        eng.close()


# --------------------------------------------------------- validation


def test_tp_requires_paged(params):
    with pytest.raises(ValueError, match='requires paged'):
        tengine.DecodeEngine(params[1], CFG, _dcfg(), 2, tp=2)


def test_tp_must_divide_heads(params):
    # debug: n_heads=4, n_kv_heads=2; tp=4 leaves no whole KV head.
    with pytest.raises(ValueError, match='divide'):
        tengine.DecodeEngine(params[1], CFG, _dcfg(), 2, paged=True, tp=4)


def test_tp_engine_needs_a_group(params):
    # The engine makes no group of its own: build_engine does.
    with pytest.raises(ValueError, match='needs a TP group'):
        tengine.DecodeEngine(params[1], CFG, _dcfg(), 2, paged=True, tp=2)


def test_tp_exceeding_devices_raises():
    with pytest.raises(ValueError, match='exceeds'):
        mesh.serving_devices(3, ['cpu', 'cpu'])
    with pytest.raises(ValueError, match='exceeds'):
        mesh.serving_devices(torch.cuda.device_count() + 1)


def test_tp_below_one_raises(params):
    with pytest.raises(ValueError, match='tp'):
        tengine.DecodeEngine(params[1], CFG, _dcfg(), 2, paged=True, tp=0)
    with pytest.raises(ValueError, match='tp must be >= 1'):
        mesh.serving_devices(0)


def test_no_silent_backend_or_rounds(group):
    """NCCL refuses a card repeated across ranks and any CPU rank; graph
    rounds refuse a gloo group on cards (its collectives copy through the
    host and cannot be captured). Nothing falls back."""
    two_on_one = [torch.device('cuda:0')] * 2
    with pytest.raises(ValueError, match='repeats'):
        mesh.check_backend('nccl', two_on_one)
    with pytest.raises(ValueError, match='card a rank'):
        mesh.check_backend('nccl', [torch.device('cpu')] * 2)
    with pytest.raises(ValueError, match='backend'):
        mesh.check_backend('mpi', two_on_one)
    mesh.check_backend('gloo', two_on_one)
    shared = tp_lib.TPGroup(0, two_on_one, 'gloo', ctrl=None)
    assert shared.path == 'gloo-host-copy'
    with pytest.raises(ValueError, match="rounds='graph' needs an nccl"):
        tengine.check_tp(2, shared, CFG, True, 'graph')
    tengine.check_tp(2, shared, CFG, True, 'eager')
    assert group.path == 'gloo'


# ------------------------------------------- server + bootstrap wiring


def test_build_engine_tp_env(params, group, monkeypatch):
    monkeypatch.setenv(model_server.SERVE_TP_ENV, '2')
    eng = model_server.build_engine('debug', 2, 64, paged=True,
                                    attn='plain', block_k=8, device='cpu',
                                    params=params[1], tp_group=group)
    try:
        assert eng.tp == 2
        assert _pool_shapes(eng)[1]['k'][3] == CFG.n_kv_heads // 2
    finally:
        eng.close()


def test_build_engine_tp_arg_overrides_env(monkeypatch):
    monkeypatch.setenv(model_server.SERVE_TP_ENV, '2')
    eng = model_server.build_engine('debug', 2, 64, paged=True,
                                    attn='plain', block_k=8, device='cpu',
                                    tp=1)
    assert eng.tp == 1 and eng.stats()['tp'] == 1


def test_distributed_env_parsing(monkeypatch):
    monkeypatch.delenv(distributed.COORDINATOR_ENV, raising=False)
    assert distributed.distributed_env() is None
    monkeypatch.setenv(distributed.COORDINATOR_ENV, '10.0.0.1:8476')
    monkeypatch.setenv(distributed.NUM_PROCESSES_ENV, '1')
    assert distributed.distributed_env() is None  # nothing to rendezvous
    monkeypatch.setenv(distributed.NUM_PROCESSES_ENV, '4')
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, '3')
    assert distributed.distributed_env() == {
        'coordinator_address': '10.0.0.1:8476', 'num_processes': 4,
        'process_id': 3}
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, 'three')
    assert distributed.distributed_env() is None


def test_maybe_initialize_forms_the_process_group_once(monkeypatch):
    """The gang env triple becomes one init_process_group call (the
    opt-out env suppresses it; a second call is a no-op)."""
    calls = []
    monkeypatch.setattr(torch.distributed, 'init_process_group',
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv(distributed.COORDINATOR_ENV, '10.0.0.1:8476')
    monkeypatch.setenv(distributed.NUM_PROCESSES_ENV, '2')
    monkeypatch.setenv(distributed.PROCESS_ID_ENV, '0')
    monkeypatch.setenv(distributed.DISABLE_ENV, '1')
    monkeypatch.setattr(distributed, '_initialized', False)
    assert distributed.maybe_initialize() is False  # opted out
    monkeypatch.delenv(distributed.DISABLE_ENV)
    assert distributed.maybe_initialize() is True
    assert calls == [{'backend': 'gloo',
                      'init_method': 'tcp://10.0.0.1:8476',
                      'world_size': 2, 'rank': 0,
                      'timeout': distributed.TP_TIMEOUT}]
    assert distributed.maybe_initialize() is True  # idempotent
    assert len(calls) == 1
    monkeypatch.setattr(distributed, '_initialized', False)


def _free_port():
    import socket  # pylint: disable=import-outside-toplevel
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def test_gang_processes_serve_one_tp_replica(group):
    """Two processes of a gang (the gang's env triple) both run the
    server's entry point with --tp 2: process 0 serves HTTP and process 1
    runs the worker loop. The replica answers with the tokens a local
    tp=2 engine over the same seeded params gives, and process 1 exits
    once process 0 is gone."""
    import json  # pylint: disable=import-outside-toplevel
    import subprocess  # pylint: disable=import-outside-toplevel
    import sys  # pylint: disable=import-outside-toplevel
    import urllib.request  # pylint: disable=import-outside-toplevel
    http_port = _free_port()
    env = dict(os.environ, **{
        distributed.COORDINATOR_ENV: f'127.0.0.1:{_free_port()}',
        distributed.NUM_PROCESSES_ENV: '2'})
    env.pop(model_server.SERVE_TP_ENV, None)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.serve.model_server',
           '--model', 'debug', '--device', 'cpu', '--paged', '--block-k',
           '8', '--max-len', '64', '--tp', '2', '--port', str(http_port)]
    procs = [subprocess.Popen(cmd, env=dict(env, **{
        distributed.PROCESS_ID_ENV: str(r)}), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for r in (1, 0)]
    prompt = _prompts()[1]
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f'http://127.0.0.1:{http_port}/healthz',
                        timeout=5) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                assert time.time() < deadline, 'the gang never served'
                time.sleep(0.2)
        req = urllib.request.Request(
            f'http://127.0.0.1:{http_port}/generate',
            data=json.dumps({'prompt': prompt, 'max_new_tokens': 6,
                             'stream': False}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
        with urllib.request.urlopen(f'http://127.0.0.1:{http_port}/stats',
                                    timeout=10) as resp:
            assert json.loads(resp.read())['tp'] == 2
    finally:
        procs[1].send_signal(signal.SIGTERM)
        procs[1].wait(timeout=60)
        # Process 1 leaves once process 0 is gone.
        procs[0].wait(timeout=60)
    eng = model_server.build_engine('debug', 8, 64, paged=True, block_k=8,
                                    device='cpu', tp_group=group, tp=2)
    try:
        want = tengine.Request(prompt, 6)
        _drain(eng, [want])
    finally:
        eng.close()
    assert got['tokens'] == want.tokens


# A gang the server refuses: its arguments and what process 0 says.
GANG_FAILURES = {
    'no-tp': (['--paged'], 'serves one replica at tp=2'),
    'tp-1': (['--paged', '--tp', '1'], 'serves one replica at tp=2'),
    'tp-2-dense': (['--tp', '2'], 'requires paged=True'),
}


@pytest.fixture(scope='module')
def failed_gangs():
    """Each GANG_FAILURES gang's return codes and stderr, [worker,
    process 0]; the three gangs (six processes) run at once."""
    import subprocess  # pylint: disable=import-outside-toplevel
    import sys  # pylint: disable=import-outside-toplevel
    gangs = {}
    try:
        for case, (args, _) in GANG_FAILURES.items():
            env = dict(os.environ, **{
                distributed.COORDINATOR_ENV: f'127.0.0.1:{_free_port()}',
                distributed.NUM_PROCESSES_ENV: '2'})
            env.pop(model_server.SERVE_TP_ENV, None)
            env.pop(distributed.DISABLE_ENV, None)
            cmd = [sys.executable, '-m',
                   'skypilot_tpu_torch.serve.model_server', '--model',
                   'debug', '--device', 'cpu', '--block-k', '8',
                   '--max-len', '64', '--port', str(_free_port())] + args
            gangs[case] = [subprocess.Popen(cmd, env=dict(env, **{
                distributed.PROCESS_ID_ENV: str(r)}),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
                for r in (1, 0)]
        out = {}
        for case, procs in gangs.items():
            errs = [p.communicate(timeout=60)[1].decode() for p in procs]
            out[case] = ([p.returncode for p in procs], errs)
        return out
    finally:
        for procs in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.mark.parametrize('case', list(GANG_FAILURES))
def test_gang_fails_together_instead_of_hanging(failed_gangs, case):
    """A gang is one TP replica. A degree other than its process count
    (none given is 1) fails every process before any serves; a replica
    that process 0 refuses to build (tp > 1 needs paged) fails the
    worker too, which never waits on a peer that is gone."""
    codes, errs = failed_gangs[case]
    assert codes[0] != 0 and codes[1] != 0
    # Process 0 names the cause.
    assert GANG_FAILURES[case][1] in errs[1], errs[1][-2000:]


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_tp1():
    """Two ranks sharing one card over gloo (host copies), eager rounds:
    tokens equal a tp=1 replica's on the card, each rank's pool holds
    Hkv/2 heads and the paged-decode kernel ran on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    gen = torch.Generator(device='cuda').manual_seed(0)
    p = tllama.init_params(CFG, gen, 'cuda')
    group = tp_lib.local_group(2, ['cuda:0', 'cuda:0'], 'gloo')
    try:
        want = _run(_engine(p, _dcfg(attn='kernel'), rounds='eager'))
        e2 = tengine.DecodeEngine(
            p, CFG, _dcfg(attn='kernel'), 2, step_chunk=2,
            prefill_buckets=(16, 32), paged=True, num_blocks=40, tp=2,
            tp_group=group, rounds='eager')
        assert _run(e2) == want
        stats = e2.rank_stats()
        for s in stats:
            assert s['pool_shapes']['k'][3] == CFG.n_kv_heads // 2
            assert s['launches']['paged_decode_attention_kernel'] > 0
        assert stats[0]['launches'] == stats[1]['launches']
        e2.close()
    finally:
        group.close()


# ----------------------------------------------------- a lost worker
# Last: it kills the file's group.


def test_killed_worker_fails_rank_0_within_the_timeout(params, group):
    """A worker killed mid-service surfaces on rank 0 as an engine
    failure (the supervisor's path: in-flight requests answered with an
    error, the engine failed for good), within seconds, never a hang."""
    eng = _engine(params[1], _dcfg(), group, name='t-tp-kill')
    _run(eng)
    os.kill(group._procs[0].pid, signal.SIGKILL)  # pylint: disable=protected-access
    group._procs[0].wait(timeout=10)  # pylint: disable=protected-access
    req = eng.submit(tengine.Request(_prompts()[1], 4))
    stop = threading.Event()
    t0 = time.perf_counter()
    loop = threading.Thread(target=eng.run_forever, args=(stop,),
                            daemon=True)
    loop.start()
    assert req.wait(timeout=30), 'rank 0 hung on a dead worker'
    loop.join(timeout=30)
    assert not loop.is_alive()
    assert time.perf_counter() - t0 < 30
    assert eng.failed and 'rank is lost' in eng.fail_reason
    assert req.finish_reason.startswith('error') or \
        req.finish_reason.startswith('engine failed')
    stop.set()
    eng.close()
