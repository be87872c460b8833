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
  over a reallocated pool raises;
* the compiled ``decode.generate`` (``decode.GenerateProgram``, the
  reference's ``_generate_impl``) on the stand-in capturer: the
  reference's tokens under bf16, int8 K/V and int8 weights with an EOS
  that stops rows mid-run, a second call on the same cache equal to a
  fresh eager call, one capture a key, and a failed capture raising;
* the dense insert (``('prefill', bucket)``, the reference's
  ``_prefill_greedy_impl``) with its length and lane as 0-d tensors:
  the reference's first tokens and lane K/V for three lengths of one
  bucket in two lanes, the other lanes untouched, one capture.

On the card (``cuda`` marker): the graph path against the eager one,
tokens identical and pools ``torch.equal``, for dense (bf16 and int8
K/V), paged, int8 K/V, int8 weights, spec and chunked engines; the
compiled generate against the eager loop (greedy in three configs and
sampled), launches exact; a capture that fails raises. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py``;
this file imports JAX only inside the CPU cases that run the reference.
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
# Two bf16 ulps of the debug model's logits (tests/test_torch_decode.py).
BF16_ATOL = 1.6e-2


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


@pytest.fixture(scope='module')
def ref():
    """The reference's debug params (seed 0) and the port's copy of
    them; JAX is imported here, never at module import."""
    import jax  # the reference runs on the CPU only; see the docstring
    from skypilot_tpu.models import llama as jllama
    from skypilot_tpu_torch.models import convert

    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS['debug'])
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)


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


def test_paged_step_chunk_4_matches_reference_engine(ref):
    """5 requests through 2 slots (lanes evict and refill mid-run) and a
    sixth submitted mid-run: the port's compiled-round path gives the
    reference engine's tokens, request by request, with one capture a
    key and the rest replays."""
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import engine as jengine
    from skypilot_tpu.models import llama as jllama

    jcfg = jllama.CONFIGS['debug']
    jp, tp = ref
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
    prompt, lens = torch.zeros((1, 4), dtype=torch.int64), torch.tensor([4])
    with pytest.raises(ValueError, match='rounds must be one of'):
        tdecode.generate(tparams, prompt, lens, CFG,
                         tdecode.DecodeConfig(max_len=16), 2, rounds='jit')
    # The CPU runs a 'graph' generate eagerly: no program is made.
    tdecode.generate(tparams, prompt, lens, CFG,
                     tdecode.DecodeConfig(max_len=16), 2)
    assert tdecode.generate_programs() == []


# Compiled generate and dense-insert cases: bf16, int8 K/V, int8 weights.
CONFIG_CASES = {'bf16': {}, 'int8_kv': {'kv_cache_dtype': 'int8'},
                'int8_weights': {'int8': True}}
# 21 new tokens: the prefill's first token, one round of
# GENERATE_ROUND (16) steps and a remainder round of 4.
GEN_NEW = tdecode.GENERATE_ROUND + 5


def _case_params(jp, tp, case):
    """(reference params, port params, port DecodeConfig kwargs)."""
    kw = dict(CONFIG_CASES[case])
    if kw.pop('int8', False):
        from skypilot_tpu.models import decode as jdecode
        jp, tp = jdecode.quantize_params(jp), tdecode.quantize_params(tp)
    return jp, tp, kw


def _gen_prompts(seed, lens, s=8):
    prompt = np.random.RandomState(seed).randint(
        0, CFG.vocab_size, (len(lens), s)).astype(np.int64)
    for row, n in enumerate(lens):
        prompt[row, n:] = 0
    return torch.from_numpy(prompt), torch.tensor(lens)


def _mid_run_eos(tokens):
    """(eos, row, step): a token that first appears at ``step`` (past
    the second) of ``row`` of a generation without EOS, so that taken as
    the EOS it stops the row mid-run."""
    for row, toks in enumerate(tokens.tolist()):
        for step in range(2, len(toks) - 2):
            if toks[step] not in toks[:step]:
                return toks[step], row, step
    raise AssertionError(f'no token to stop a row mid-run: {tokens}')


@pytest.mark.parametrize('case', sorted(CONFIG_CASES))
def test_compiled_generate_matches_reference_and_reuses_its_cache(ref,
                                                                   case):
    """``GenerateProgram`` on the stand-in capturer (the bodies the card
    captures; a replay runs its body again): tokens identical to the
    reference's ``generate``, with an eos_id that stops a row mid-run;
    a second call with other prompts and shorter lengths on the same
    cache equals a fresh eager call, so no K/V of the first call reaches
    it; one capture a key (the prefill, a round of GENERATE_ROUND steps,
    the remainder) and replays after."""
    import jax.numpy as jnp
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import llama as jllama

    jp, tp, kw = _case_params(*ref, case)
    prompt, lens = _gen_prompts(3, [8, 6, 3])
    dcfg = tdecode.DecodeConfig(max_len=32, **kw)
    probe = tdecode.generate(tp, prompt, lens, CFG, dcfg, GEN_NEW)
    eos, row, stop = _mid_run_eos(probe)
    dcfg = tdecode.DecodeConfig(max_len=32, eos_id=eos, **kw)
    want = np.asarray(jdecode.generate(
        jp, jnp.asarray(prompt.numpy()), jnp.asarray(lens.numpy()),
        jllama.CONFIGS['debug'],
        jdecode.DecodeConfig(max_len=32, eos_id=eos, decode_attention='xla',
                             **kw), GEN_NEW))
    program = tdecode.GenerateProgram(tp, CFG, dcfg, 3, 8, GEN_NEW, 'cpu',
                                      StandInCapturer())
    got = program.run(prompt, lens).numpy()
    np.testing.assert_array_equal(got, want)
    assert tdecode.completed_token_counts(got, eos)[row] == stop + 1
    assert program.graphs.captures == {'generate_prefill': 1,
                                       'generate_steps': 2}
    assert program.graphs.replays == 0
    prompt2, lens2 = _gen_prompts(4, [5, 2, 7])
    again = program.run(prompt2, lens2)
    assert torch.equal(again, tdecode.generate(tp, prompt2, lens2, CFG, dcfg,
                                               GEN_NEW))
    assert program.graphs.replays == 3
    assert sum(program.graphs.captures.values()) == 3


def test_compiled_generate_raises_when_a_capture_fails(tparams):
    """A capture that fails raises out of the call: nothing falls back to
    the eager loop."""

    class FailingCapturer(StandInCapturer):
        def capture(self, fn):
            raise RuntimeError('capture failed')

    prompt, lens = _gen_prompts(1, [4, 4])
    program = tdecode.GenerateProgram(
        tparams, CFG, tdecode.DecodeConfig(max_len=16), 2, 8, 3, 'cpu',
        FailingCapturer())
    with pytest.raises(RuntimeError, match='capture failed'):
        program.run(prompt, lens)
    with pytest.raises(ValueError, match='exceeds max_len'):
        tdecode.GenerateProgram(tparams, CFG,
                                tdecode.DecodeConfig(max_len=16), 2, 8, 9,
                                'cpu', StandInCapturer())


def _lane_kv_close(got, want, kv):
    """One lane's K/V [L, S, Hkv, hd] (and scales) against the
    reference's: layer 0 bit for bit, every layer within BF16_ATOL
    (int8: the dequantised values within two steps of the scale; later
    layers' inputs differ by XLA's excess precision)."""
    for name in ('k', 'v'):
        if kv == 'int8':
            scale = want[f'{name}_scale'][..., None]
            deq_want = want[name].astype(np.float32) * scale
            deq = got[name].astype(np.float32) * got[f'{name}_scale'][
                ..., None]
            assert (np.abs(deq - deq_want) <= 2 * scale + BF16_ATOL).all()
            np.testing.assert_array_equal(got[f'{name}_scale'][0],
                                          want[f'{name}_scale'][0])
            np.testing.assert_array_equal(got[name][0], want[name][0])
        else:
            np.testing.assert_array_equal(got[name][0], want[name][0])
            assert (np.abs(got[name] - want[name]) <= BF16_ATOL).all()


def _planes_np(cache, lane, s):
    return {name: (t[:, lane, :s].float() if t.dtype == torch.bfloat16
                   else t[:, lane, :s]).numpy()
            for name, t in cache.items()}


@pytest.mark.parametrize('case', sorted(CONFIG_CASES))
def test_dense_insert_matches_reference_greedy_prefill(ref, case):
    """The dense engine's insert dispatch ``('prefill', 16)`` on the
    graph bookkeeping, its prompt length and lane as 0-d tensors of the
    key's static buffers: for lengths 9, 13 and 16 in lanes 0, 2 and 0,
    the first token equal to the reference's ``_prefill_greedy_impl``'s,
    the lane's K/V as ``_lane_kv_close`` holds them, every other lane
    untouched (the cache starts from random bytes), and one capture
    serving every length and lane."""
    import jax.numpy as jnp
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import engine as jengine
    from skypilot_tpu.models import llama as jllama

    jp, tp, kw = _case_params(*ref, case)
    kv = kw.get('kv_cache_dtype', 'bf16')
    eng = _stand_in(engine_lib.DecodeEngine(
        tp, CFG, tdecode.DecodeConfig(max_len=32, **kw), 3,
        prefill_buckets=(16, 32)))
    gen = torch.Generator().manual_seed(5)
    for t in eng._cache.values():  # pylint: disable=protected-access
        t.view(torch.uint8).copy_(torch.randint(
            0, 256, t.view(torch.uint8).shape, generator=gen,
            dtype=torch.uint8))
    if kv == 'int8':  # finite scales, so dequantised lanes compare
        for name in ('k_scale', 'v_scale'):
            eng._cache[name].uniform_(0.0, 1.0, generator=gen)  # pylint: disable=protected-access
    jcache = jdecode.init_kv_cache(jllama.CONFIGS['debug'], 3, 32, kv)
    prompts = _prompts(3, 7, lo=16, hi=17)
    for p, lane in ((9, 0), (13, 2), (16, 0)):
        padded = np.zeros((1, 16), np.int64)
        padded[0, :p] = prompts[lane][:p]
        # Bytes, so that the random NaN patterns compare equal.
        before = {n: t.view(torch.uint8).clone()
                  for n, t in eng._cache.items()}  # pylint: disable=protected-access
        out = eng._run_dispatch(  # pylint: disable=protected-access
            ('prefill', 16),
            {'tokens': padded, 'lens': np.asarray([p, lane], np.int64)})
        first, jcache = jengine._prefill_greedy_impl(  # pylint: disable=protected-access
            jp, jnp.asarray(padded, jnp.int32), jnp.int32(p),
            jnp.int32(lane), jcache, cfg=jllama.CONFIGS['debug'])
        assert out.shape == (1,) and int(out[0]) == int(first)
        want = {n: np.asarray(a[:, lane, :16]).astype(
            np.float32 if a.dtype == jnp.bfloat16 else a.dtype)
            for n, a in jcache.items()}
        _lane_kv_close(_planes_np(eng._cache, lane, 16), want, kv)  # pylint: disable=protected-access
        keep = [i for i in range(3) if i != lane]
        for name, t in eng._cache.items():  # pylint: disable=protected-access
            t = t.view(torch.uint8)
            assert torch.equal(t[:, keep], before[name][:, keep]), name
            assert torch.equal(t[:, lane, 16:], before[name][:, lane, 16:])
    assert eng.graph_stats()['captures'] == {'prefill': 1}
    assert eng.graph_stats()['replays'] == 2


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: CUDA graphs capture only there')
    return torch.device('cuda')


CUDA_CASES = {
    'dense': dict(paged=False),
    'dense_int8_kv': dict(paged=False, kv_cache_dtype='int8'),
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


GEN_CUDA_CASES = dict(CONFIG_CASES, sampled={'temperature': 0.8})


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(GEN_CUDA_CASES))
def test_cuda_compiled_generate_equals_eager(cuda, case):
    """``decode.generate`` on the card, ``rounds='graph'`` against
    ``'eager'``: two calls of one key (the second with other prompts and
    shorter lengths, so over the first call's cache) give the eager
    loop's tokens (sampled: from generators in the same state); the
    dense decode kernel launches n_layers x (N - 1) a call on both
    paths; each of the three keys captured once, then replayed."""
    kw = dict(GEN_CUDA_CASES[case])
    int8 = kw.pop('int8', False)
    params = tllama.init_params(
        CFG, torch.Generator(device=cuda).manual_seed(0), cuda)
    if int8:
        params = tdecode.quantize_params(params)
    dcfg = tdecode.DecodeConfig(max_len=32, **kw)
    calls = [_gen_prompts(3, [8, 6, 3]), _gen_prompts(4, [5, 2, 7])]
    if 'temperature' not in kw:
        probe = tdecode.generate(params, calls[0][0].to(cuda),
                                 calls[0][1].to(cuda), CFG, dcfg, GEN_NEW,
                                 rounds='eager')
        dcfg = tdecode.DecodeConfig(max_len=32, eos_id=_mid_run_eos(
            probe.cpu())[0], **kw)
    tdecode.clear_generate_programs()
    runs = {}
    for rounds in ('graph', 'eager'):
        gen = torch.Generator(device=cuda).manual_seed(1)
        toks, launched = [], []
        for prompt, lens in calls:
            before = da.decode_attention_kernel.launches
            toks.append(tdecode.generate(
                params, prompt.to(cuda), lens.to(cuda), CFG, dcfg, GEN_NEW,
                generator=gen, rounds=rounds).cpu())
            launched.append(da.decode_attention_kernel.launches - before)
        runs[rounds] = toks
        assert launched == [CFG.n_layers * (GEN_NEW - 1)] * 2, rounds
    for got, want in zip(runs['graph'], runs['eager']):
        assert torch.equal(got, want)
    (program,) = tdecode.generate_programs()
    assert program.graphs.captures == {'generate_prefill': 1,
                                       'generate_steps': 2}
    assert program.graphs.replays == 3
    tdecode.clear_generate_programs()


@pytest.mark.cuda
def test_cuda_compiled_generate_raises_when_a_capture_fails(cuda,
                                                           monkeypatch):
    """A body that reads the device back to the host cannot be captured:
    ``rounds='graph'`` raises, and never falls back to the eager loop."""
    params = tllama.init_params(
        CFG, torch.Generator(device=cuda).manual_seed(0), cuda)
    real = tdecode.sample

    def reads_back(logits, generator, temperature):
        out = real(logits, generator, temperature)
        out.sum().item()
        return out

    monkeypatch.setattr(tdecode, 'sample', reads_back)
    prompt, lens = _gen_prompts(3, [8, 6, 3])
    tdecode.clear_generate_programs()
    with pytest.raises(RuntimeError):
        tdecode.generate(params, prompt.to(cuda), lens.to(cuda), CFG,
                         tdecode.DecodeConfig(max_len=32), 4)
    tdecode.clear_generate_programs()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sample_is_multinomials_draw(cuda):
    """The sampled draw on the card is ``torch.multinomial``'s, bit for
    bit, and leaves the generator in the same state."""
    logits = torch.randn((5, 4096), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    g1 = torch.Generator(device=cuda).manual_seed(3)
    g2 = torch.Generator(device=cuda).manual_seed(3)
    for temperature in (0.5, 1.0, 1.7):
        probs = torch.softmax(logits / temperature, dim=-1)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = tdecode.sample(logits, g2, temperature)
        assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
