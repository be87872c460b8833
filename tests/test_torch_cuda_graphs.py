"""The engine's compiled rounds (skypilot_tpu_torch/models/cuda_graphs.py
and the engine's ``_dispatch``), the counterpart of the reference's
jitted, cache-donating dispatches (skypilot_tpu/models/engine.py
``_engine_steps_impl``, ``_engine_paged_steps_impl``,
``_engine_spec_step_impl``; decode.py ``paged_prefill``,
``paged_prefill_with_prefix``).

On the CPU, with the ``debug`` config:

* the round's static inputs keep their addresses across admissions,
  evictions, spec rounds and a chunked admission, and block-table edits
  land in them;
* the paged prefills give the same bits with their lengths as 0-d
  tensors (the static buffers' form) as with ints;
* a paged greedy engine at step_chunk 4, with admissions and evictions
  mid-run, run through the graph bookkeeping (a stand-in capturer that
  re-runs the captured body on replay), gives the reference engine's
  tokens, its ``_engine_paged_steps_impl`` rounds;
* the bookkeeping itself: one capture per key; a capture's kernel
  launches recorded, not counted, and added once per replay; graphs
  dropped and captured again after ``_recover_from_crash``; a replay
  over a reallocated pool raises.

On the card (``cuda`` marker): the graph path against the eager one,
tokens identical and pools ``torch.equal``, for dense, paged, int8 K/V,
int8 weights, spec and chunked engines. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py``;
this file imports JAX only inside the CPU case that runs the reference.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import cuda_graphs
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import decode_attention as da
from skypilot_tpu_torch.ops import launch_counts
from skypilot_tpu_torch.ops import quant

torch.set_num_threads(2)

CFG = tllama.CONFIGS['debug']


class _StandInGraph:
    """What a replay does, on the CPU: the captured body again, its
    result written into the captured output, its wrapper counts not
    counted (a real replay runs no wrapper)."""

    def __init__(self, fn, out):
        self._fn, self._out = fn, out

    def replay(self):
        with launch_counts.recording():
            self._out.copy_(self._fn())


class StandInCapturer:
    """CPU stand-in for ``cuda_graphs.CudaCapturer``. Its capture runs
    the body once to make the static output: an engine's bodies are
    idempotent on their inputs (the same K/V to the same slots, greedy
    tokens), so this rewrites what the warm-up wrote."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return _StandInGraph(fn, out), out

    def pool_bytes(self):
        return 0, 0


def _stand_in(eng):
    """Put ``eng`` (a CPU engine) on the graph bookkeeping."""
    eng._graphs = cuda_graphs.GraphCache(StandInCapturer())  # pylint: disable=protected-access
    eng._graphs.reset()  # pylint: disable=protected-access
    eng._init_runtime_state()  # pylint: disable=protected-access
    return eng


@pytest.fixture(scope='module')
def tparams():
    gen = torch.Generator().manual_seed(0)
    return tllama.init_params(CFG, gen, 'cpu')


def _prompts(n, seed, lo=3, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size,
                        size=int(rng.randint(lo, hi))).tolist()
            for _ in range(n)]


def _paged(params, cfg=CFG, step_chunk=4, rounds='graph', **dcfg):
    chunk = dcfg.pop('prefill_chunk', 0)
    dcfg = {'max_len': 64, 'kernel_block_k': 8, **dcfg}
    return engine_lib.DecodeEngine(
        params, cfg, tdecode.DecodeConfig(**dcfg), 2,
        step_chunk=step_chunk, prefill_buckets=(16, 32), paged=True,
        num_blocks=40, prefill_chunk=chunk, rounds=rounds)


def _drain(eng, reqs, max_steps=500, each_step=None):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        if each_step is not None:
            each_step(steps)
        steps += 1
        assert steps < max_steps, 'engine did not converge'


# -------------------------------------------------------------------- CPU


def test_static_inputs_keep_addresses_and_take_table_edits(tparams):
    """Admissions, evictions, spec rounds and a chunked admission never
    move the round's static inputs; after each fill the device tables
    equal the host's, and each prefill key keeps its buffers."""
    eng = _paged(tparams, step_chunk=1, spec_k=2, prefill_chunk=8)
    ptrs = {k: t.data_ptr() for k, t in eng._round_in.items()}  # pylint: disable=protected-access
    prefill_ptrs = {}
    tables_seen = []

    def check(_):
        assert {k: t.data_ptr()
                for k, t in eng._round_in.items()} == ptrs  # pylint: disable=protected-access
        for key, buf in eng._prefill_in.items():  # pylint: disable=protected-access
            got = [t.data_ptr() for t in buf.values()]
            assert prefill_ptrs.setdefault(key, got) == got
        eng._fill(eng._round_in, eng._round_fills())  # pylint: disable=protected-access
        tables = eng._round_in['tables']  # pylint: disable=protected-access
        assert np.array_equal(tables.numpy(), eng._block_table_np)  # pylint: disable=protected-access
        tables_seen.append(tables.numpy().copy())

    prompts = _prompts(4, 5, lo=4, hi=10) + [_prompts(1, 6, 25, 30)[0]]
    reqs = [engine_lib.Request(p, 6) for p in prompts]
    _drain(eng, reqs, each_step=check)
    st = eng.stats()
    assert st['admitted'] == st['evicted'] == 5
    assert st['chunked_admissions'] == 1 and st['spec_drafted'] > 0
    # The tables changed under the fixed buffer: rows filled and freed.
    assert len({t.tobytes() for t in tables_seen}) > 2
    assert (tables_seen[-1] == engine_lib.SCRATCH_BLOCK).all()
    assert {key[0] for key in prefill_ptrs} == {
        'paged_prefill', 'paged_prefill_with_prefix'}


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_paged_prefills_take_tensor_lengths_bit_for_bit(tparams, kv_dtype):
    """The lengths as 0-d tensors (the engine's static buffers) and as
    ints give the same logits and the same pool, bit for bit."""
    bk, bucket = 8, 16
    pool0 = tdecode.init_block_pool(CFG, 12, bk, kv_dtype)
    tokens = torch.as_tensor([_prompts(1, 1, 16, 17)[0]])
    row = torch.as_tensor([3, 5])
    outs = []
    for lens in ((11,), (torch.tensor(11),)):
        pool = {k: v.clone() for k, v in pool0.items()}
        logits = tdecode.paged_prefill(tparams, tokens, lens[0], row, CFG,
                                       pool)
        outs.append((logits, pool))
    assert torch.equal(outs[0][0], outs[1][0])
    for name in pool0:
        assert torch.equal(outs[0][1][name], outs[1][1][name])
    pref = torch.as_tensor([3, 0])           # a padded prefix bucket
    srow = torch.as_tensor([5, 7, 9])        # bucket // bk + 1 blocks
    got = []
    for suf, pre in ((9, 6), (torch.tensor(9), torch.tensor(6))):
        pool = {k: v.clone() for k, v in outs[0][1].items()}
        logits = tdecode.paged_prefill_with_prefix(
            tparams, tokens[:, :bucket], suf, pre, pref, srow, CFG, pool)
        got.append((logits, pool))
    assert torch.equal(got[0][0], got[1][0])
    for name in pool0:
        assert torch.equal(got[0][1][name], got[1][1][name])


def test_paged_step_chunk_4_matches_reference_engine(tparams):
    """5 requests through 2 slots (lanes evict and refill mid-run) and a
    sixth submitted mid-run: the port's compiled-round path gives the
    reference engine's tokens, request by request, with one capture a
    key and the rest replays."""
    import jax  # the reference runs on the CPU only; see the docstring
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import engine as jengine
    from skypilot_tpu.models import llama as jllama
    from skypilot_tpu_torch.models import convert

    jcfg = jllama.CONFIGS['debug']
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)
    # Seed 1: seed 0's sixth prompt meets an exact bf16 tie at its fourth
    # token in both packages (ROADMAP.md, faults queue, item 2).
    prompts = _prompts(6, 1)
    news = [4, 9, 3, 6, 8, 7]
    eng = _stand_in(_paged(tp))
    jeng = jengine.DecodeEngine(
        jp, jcfg, jdecode.DecodeConfig(max_len=64, kernel_block_k=8,
                                       decode_attention='xla'),
        2, step_chunk=4, prefill_buckets=(16, 32), paged=True,
        num_blocks=40, name='t-torch-graphs')
    got = []
    for e, mod in ((eng, engine_lib), (jeng, jengine)):
        reqs = [mod.Request(p, n) for p, n in zip(prompts, news)]
        late = reqs.pop()

        def admit_late(step, e=e, late=late):
            if step == 2:
                e.submit(late)

        _drain(e, reqs, each_step=admit_late)
        while not late.done:
            e.step()
        got.append([r.tokens for r in reqs + [late]])
    assert got[0] == got[1]
    assert [len(t) for t in got[0]] == news
    gs = eng.graph_stats()
    assert gs['captures']['decode_steps'] == 1
    assert gs['replays'] > 0 and gs['graphs'] == sum(gs['captures'].values())


def test_capture_records_launches_and_replays_add_them():
    """The warm-up counts for real; the capture's wrapper calls are
    recorded, never counted; each replay adds them; one capture a key."""
    kernels = (da.decode_attention_kernel, quant.int8_gemm_library)
    x = torch.zeros(3)

    def body():
        launch_counts.count(da.decode_attention_kernel)
        launch_counts.count(da.decode_attention_kernel)
        launch_counts.count(quant.int8_gemm_library)
        return x + 1

    cache = cuda_graphs.GraphCache(StandInCapturer())
    before = [fn.launches for fn in kernels]
    cache.run(('decode_steps', 4, True), body, (1,))
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [2, 1]
    for _ in range(5):
        out = cache.run(('decode_steps', 4, True), body, (1,))
    assert torch.equal(out, x + 1)
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [12, 6]
    assert cache.captures == {'decode_steps': 1} and cache.replays == 5
    with pytest.raises(RuntimeError, match='captured over other buffers'):
        cache.run(('decode_steps', 4, True), body, (2,))


def test_restart_drops_graphs_and_a_moved_pool_raises(tparams):
    """``_recover_from_crash`` drops every graph and the pool, and the
    rebuilt engine captures again (no second ``engine.compile`` row); a
    pool whose storage changed under a captured graph makes the next
    replay raise."""
    eng = _stand_in(_paged(tparams))
    capturer = eng._graphs._capturer  # pylint: disable=protected-access
    reqs = [engine_lib.Request(p, 6) for p in _prompts(2, 3)]
    _drain(eng, reqs)
    n_graphs = eng.graph_stats()['graphs']
    captures = sum(eng.graph_stats()['captures'].values())
    compiles = len(eng._traced_shapes)  # pylint: disable=protected-access
    assert n_graphs >= 2
    resets = capturer.resets
    assert eng._recover_from_crash(RuntimeError('boom'))  # pylint: disable=protected-access
    assert eng.graph_stats()['graphs'] == 0
    assert capturer.resets == resets + 1
    again = [engine_lib.Request(p, 6) for p in _prompts(2, 3)]
    _drain(eng, again)
    assert [r.tokens for r in again] == [r.tokens for r in reqs]
    assert eng.graph_stats()['graphs'] == n_graphs
    assert sum(eng.graph_stats()['captures'].values()) == 2 * captures
    assert len(eng._traced_shapes) == compiles  # pylint: disable=protected-access
    eng._cache['k'] = eng._cache['k'].clone()  # pylint: disable=protected-access
    eng.submit(engine_lib.Request(_prompts(1, 3)[0], 6))
    with pytest.raises(RuntimeError, match='captured over other buffers'):
        for _ in range(3):
            eng.step()


def test_rounds_is_checked_and_eager_on_the_cpu(tparams):
    eng = _paged(tparams)
    assert eng.graph_stats() == {'rounds': 'eager'}
    with pytest.raises(ValueError, match='rounds must be one of'):
        _paged(tparams, rounds='jit')


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: CUDA graphs capture only there')
    return torch.device('cuda')


CUDA_CASES = {
    'dense': dict(paged=False),
    'paged': dict(paged=True),
    'int8_kv': dict(paged=True, kv_cache_dtype='int8'),
    'int8_weights': dict(paged=True, int8=True),
    'spec': dict(paged=True, spec_k=4, spec_drafter_layers=1),
    'chunked': dict(paged=True, prefill_chunk=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CUDA_CASES))
def test_cuda_graph_rounds_equal_eager(cuda, case):
    """The same requests through a graph and an eager engine on the
    card: identical tokens and pools (torch.equal, every plane); each
    kernel's launches equal between the two; the graph engine captured
    each of its keys once."""
    kw = dict(CUDA_CASES[case])
    paged = kw.pop('paged')
    int8 = kw.pop('int8', False)
    chunk = kw.pop('prefill_chunk', 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tllama.init_params(CFG, gen, cuda)
    if int8:
        params = tdecode.quantize_params(params)
    prompts = _prompts(6, 11, hi=30)
    runs = {}
    for rounds in ('graph', 'eager'):
        counters = da.KERNELS + (quant.int8_gemm_library,)
        before = [fn.launches for fn in counters]
        eng = engine_lib.DecodeEngine(
            params, CFG, tdecode.DecodeConfig(max_len=64, kernel_block_k=8,
                                              **kw),
            3, step_chunk=4, prefill_buckets=(16, 32), paged=paged,
            num_blocks=60 if paged else None, prefill_chunk=chunk,
            rounds=rounds)
        reqs = [engine_lib.Request(p, 10) for p in prompts]
        _drain(eng, reqs)
        torch.cuda.synchronize()
        runs[rounds] = ([r.tokens for r in reqs], eng._cache,  # pylint: disable=protected-access
                        [fn.launches - b for fn, b in zip(counters, before)],
                        eng.graph_stats())
    (g_tok, g_pool, g_n, g_stats), (e_tok, e_pool, e_n, _) = (
        runs['graph'], runs['eager'])
    assert g_tok == e_tok
    for name in e_pool:
        assert torch.equal(g_pool[name], e_pool[name]), name
    assert g_n == e_n and sum(g_n) > 0
    assert g_stats['replays'] > 0
    assert g_stats['graphs'] == sum(g_stats['captures'].values())
