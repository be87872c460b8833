"""Port int8 weights (skypilot_tpu_torch: ``ops/quant`` quantize_int8 /
int8_matmul, ``models/llama`` quant_mm, ``models/decode``
quantize_params, ``models/convert``, the ``--int8`` replica) against the
JAX reference on the CPU, ``debug`` config, inputs from numpy seeds.

* ``quantize_int8`` values and scales bit-equal to the reference's
  (bf16 and fp32, 2-D and stacked, an all-zero column on the 1e-8
  floor); ``int8_matmul`` bit-equal to the reference's jitted one, its
  int32 accumulator too. (Under ``jit`` XLA folds the activation scale's
  ``/ 127`` into ``* (1/127)``; the port's row quantisation does the
  same, so the rows and scales are the reference's serving path's.)
* Greedy tokens of int8 dense, paged, spec (k 2, drafter depth 1) and
  chunked-prefill replicas equal the reference's
  ``build_engine(int8=True)`` replicas';
  decode logits within BF16_ATOL (tests/test_torch_decode.py).
* ``engine.hbm`` counts a quantized weight's values and scales.

``cuda`` cases (the library GEMM against its twin, bit for bit) run on
the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_int8.py``. The reference is imported inside a fixture,
so the card, which has no jax, collects this file.
"""
import types

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import quant as tquant
from skypilot_tpu_torch.serve import model_server

torch.set_num_threads(2)

CFG = tllama.CONFIGS['debug']
BF16_ATOL = 1.6e-2


@pytest.fixture(scope='module')
def ref():
    """The JAX reference (imported here, not at module import)."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.models import decode, engine, llama
    from skypilot_tpu.ops import quant
    from skypilot_tpu.serve import model_server as server
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, decode=decode, engine=engine, llama=llama,
        quant=quant, server=server, cfg=llama.CONFIGS['debug'],
        dtypes={'bf16': jnp.bfloat16, 'fp32': jnp.float32})


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits (so -0.0 and 0.0 differ, as they would on the
    wire)."""
    t = t.detach().cpu().contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(width).numpy()


def _jbits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def _pair(ref, seed, shape, dtype, scale=0.05):
    """The same numbers for both packages: numpy → jnp (cast to dtype)
    → numpy → torch."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    j = ref.jnp.asarray(x * scale).astype(ref.dtypes[dtype])
    return j, convert.tensor_from_numpy(np.asarray(j))


@pytest.fixture(scope='module')
def params(ref):
    jp = ref.llama.init_params(ref.jax.random.PRNGKey(0), ref.cfg)
    return jp, convert.params_from_numpy(
        ref.jax.tree.map(np.asarray, jp), CFG)


# ----------------------------------------------------------- ops/quant.py


@pytest.mark.parametrize('dtype', ['bf16', 'fp32'])
@pytest.mark.parametrize('shape,axis', [((64, 96), 0), ((3, 64, 96), 1)])
def test_quantize_int8_bit_equal_to_reference(ref, dtype, shape, axis):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 0.05
    x[..., 7] = 0.0     # an all-zero output channel: the 1e-8 floor
    jw = ref.jnp.asarray(x).astype(ref.dtypes[dtype])
    tw = convert.tensor_from_numpy(np.asarray(jw))
    want = ref.quant.quantize_int8(jw, axis)
    got = tquant.quantize_int8(tw, axis)
    assert got.shape == tuple(want.shape)
    assert got.values.dtype == torch.int8
    assert got.scale.dtype == torch.float32
    assert got.scale.shape == tuple(want.scale.shape)
    np.testing.assert_array_equal(_bits(got.values), _jbits(want.values))
    np.testing.assert_array_equal(_bits(got.scale), _jbits(want.scale))
    assert float(got.scale[..., 7].max()) == np.float32(1e-8) / np.float32(
        127.0)
    # Stored K-major, the layout the card's int8 GEMM takes.
    assert got.values.stride(axis) == 1


def test_quantized_tensor_index_slices_both_fields(ref):
    _, tw = _pair(ref, 2, (3, 64, 96), 'bf16')
    qw = tquant.quantize_int8(tw, 1)
    layer = qw[1]
    assert isinstance(layer, tquant.QuantizedTensor)
    assert layer.shape == (64, 96) and layer.scale.shape == (1, 96)
    assert torch.equal(layer.values, qw.values[1])
    assert torch.equal(layer.scale, qw.scale[1])
    assert layer.values.stride(0) == 1
    assert qw.nbytes == 3 * 64 * 96 + 3 * 96 * 4


@pytest.mark.parametrize('dtype', ['bf16', 'fp32'])
@pytest.mark.parametrize('lead', [(1,), (5,), (8,), (40,), (2, 5), (8, 5)])
def test_int8_matmul_bit_equal_to_reference_jit(ref, dtype, lead):
    """2-D and 3-D x at M in {1, 5, 8, 40} (and the verify step's [8,
    5]): the output and the int32 accumulator bit-equal to the
    reference's jitted int8_matmul and dot_general."""
    jw, tw = _pair(ref, 3, (64, 96), 'bf16')
    jq = ref.quant.quantize_int8(jw, 0)
    tq = tquant.quantize_int8(tw, 0)
    jx, tx = _pair(ref, 4, lead + (64,), dtype, scale=1.0)
    jax, jquant = ref.jax, ref.quant
    want = jax.jit(jquant.int8_matmul)(jx, jq)
    got = tquant.int8_matmul(tx, tq)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _jbits(want))
    np.testing.assert_array_equal(
        _bits(tquant.int8_matmul_plain(tx, tq)), _jbits(want))

    def ref_acc(x, q):
        xq, _ = jquant._quantize_rows(x)  # pylint: disable=protected-access
        return jax.lax.dot_general(xq, q.values,
                                   (((x.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=ref.jnp.int32)

    xq, _ = tquant._quantize_rows(tx)  # pylint: disable=protected-access
    acc = tquant.int8_gemm_plain(xq.reshape(-1, 64), tq.values)
    np.testing.assert_array_equal(acc.reshape(lead + (96,)).numpy(),
                                  np.asarray(jax.jit(ref_acc)(jx, jq)))
    # out_dtype as the reference reads it.
    want32 = jax.jit(lambda x, q: jquant.int8_matmul(x, q, ref.jnp.float32))(
        jx, jq)
    np.testing.assert_array_equal(
        _bits(tquant.int8_matmul(tx, tq, torch.float32)), _jbits(want32))


def test_int8_route_dispatch_never_falls_back():
    # The device alone picks the product: the CPU the twin, CUDA the
    # library GEMM, anything else nothing.
    # pylint: disable=protected-access
    assert tquant._product('cpu') is tquant.int8_gemm_plain
    assert tquant._product('cuda') is tquant.int8_gemm_library
    assert tquant._product(torch.device('cuda', 0)) is (
        tquant.int8_gemm_library)
    with pytest.raises(ValueError, match='no int8 GEMM'):
        tquant._product('meta')
    with pytest.raises(ValueError, match='no int8 GEMM'):
        tquant.int8_matmul(torch.ones(2, 64, device='meta'),
                           tquant.quantize_int8(torch.ones(64, 8), 0))
    xq = torch.ones((2, 64), dtype=torch.int8)
    wq = tquant.k_major(torch.ones((64, 8), dtype=torch.int8), 0)
    before = tquant.int8_gemm_library.launches
    # The library route takes CUDA tensors only, and counts no refusal.
    with pytest.raises(ValueError, match='CUDA'):
        tquant.int8_gemm_library(xq, wq)
    assert tquant.int8_gemm_library.launches == before
    with pytest.raises(ValueError, match='int8 operands'):
        tquant.int8_gemm_plain(xq.float(), wq)
    with pytest.raises(ValueError, match='2-D'):
        tquant.int8_matmul(torch.ones(2, 64), tquant.quantize_int8(
            torch.ones(3, 64, 8), 1))


def test_quant_mm_dispatches_on_quantized_weights(ref):
    _, tw = _pair(ref, 5, (64, 96), 'bf16')
    _, tw2 = _pair(ref, 6, (64, 32), 'bf16')
    _, tx = _pair(ref, 7, (2, 3, 64), 'bf16', scale=1.0)
    # A plain tensor is x @ w, untouched (training's path).
    assert torch.equal(tllama.quant_mm(tx, tw), tx @ tw)
    qw, qw2 = tquant.quantize_int8(tw, 0), tquant.quantize_int8(tw2, 0)
    assert torch.equal(tllama.quant_mm(tx, qw), tquant.int8_matmul(tx, qw))
    # Shared-input quantisation: the same bits as one call per weight.
    both = tllama.quant_mms(tx, qw, qw2)
    assert torch.equal(both[0], tquant.int8_matmul(tx, qw))
    assert torch.equal(both[1], tquant.int8_matmul(tx, qw2))
    mixed = tllama.quant_mms(tx, qw, tw2)
    assert torch.equal(mixed[0], tquant.int8_matmul(tx, qw))
    assert torch.equal(mixed[1], tx @ tw2)


# ---------------------------------------------- quantize_params, bridge


def test_quantize_params_and_bridge_bit_equal_to_reference(ref, params):
    jp, tp = params
    jq = ref.decode.quantize_params(jp)
    tq = tdecode.quantize_params(tp)
    bridged = convert.params_from_numpy(ref.jax.tree.map(np.asarray, jq),
                                        CFG)
    for name, shape in tllama.param_shapes(CFG)['layers'].items():
        want = jq['layers'][name]
        for got in (tq['layers'][name], bridged['layers'][name]):
            if name in tdecode.QUANTIZED_WEIGHTS:
                assert isinstance(got, tquant.QuantizedTensor)
                assert got.shape == shape
                assert got.scale.shape == (shape[0], 1, shape[2])
                assert got.values.stride(1) == 1      # K-major
                np.testing.assert_array_equal(_bits(got.values),
                                              _jbits(want.values))
                np.testing.assert_array_equal(_bits(got.scale),
                                              _jbits(want.scale))
            else:
                np.testing.assert_array_equal(_bits(got), _jbits(want))
    for name in ('tok_embedding', 'out_norm', 'lm_head'):
        assert tq[name] is tp[name]
        np.testing.assert_array_equal(_bits(bridged[name]),
                                      _jbits(jq[name]))
    # The bridge shape-checks the scales too.
    bad = ref.jax.tree.map(np.asarray, jq)
    bad['layers']['wq'] = ref.quant.QuantizedTensor(
        values=bad['layers']['wq'].values,
        scale=bad['layers']['wq'].scale[:, :, :8])
    with pytest.raises(ValueError, match='wq.scale'):
        convert.params_from_numpy(bad, CFG)


def test_quantized_decode_logits_match_reference(ref, params):
    """Teacher-forced prefill + decode steps through the dense cache
    with int8 weights: logits within BF16_ATOL of the reference's (xla
    path), greedy tokens equal. (The replicas below cover paged and
    spec.)"""
    jp, tp = params
    jq = ref.decode.quantize_params(jp)
    tq = tdecode.quantize_params(tp)
    rng = np.random.RandomState(11)
    b, s, steps, max_len = 2, 8, 4, 32
    prompt = rng.randint(0, CFG.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    forced = rng.randint(0, CFG.vocab_size, (steps, b)).astype(np.int32)
    jd = ref.decode.DecodeConfig(max_len=max_len, decode_attention='xla')
    td = tdecode.DecodeConfig(max_len=max_len, decode_attention='plain')
    jnp, jdecode = ref.jnp, ref.decode
    jcache = jdecode.init_kv_cache(ref.cfg, b, max_len)
    first, jcache = jdecode.prefill(jq, jnp.asarray(prompt), ref.cfg,
                                    jcache, jnp.asarray(lens))
    refs = [np.asarray(first)]
    pos = jnp.asarray(lens)
    for t in range(steps):
        out, jcache = jdecode._decode_step(  # pylint: disable=protected-access
            jq, jnp.asarray(forced[t]), pos, ref.cfg, jd, jcache)
        refs.append(np.asarray(out))
        pos = pos + 1
    tcache = tdecode.init_kv_cache(CFG, b, max_len)
    got = [tdecode.prefill(tq, torch.from_numpy(prompt), CFG, tcache,
                           torch.from_numpy(lens)).numpy()]
    tpos = torch.from_numpy(lens)
    for t in range(steps):
        got.append(tdecode.decode_step(tq, torch.from_numpy(forced[t]),
                                       tpos, CFG, td, tcache).numpy())
        tpos = tpos + 1
    for r, g in zip(refs, got):
        np.testing.assert_allclose(g, r, atol=BF16_ATOL, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))
    # The int8 weights did run: the bf16 weights' logits differ.
    bf16 = tdecode.prefill(tp, torch.from_numpy(prompt), CFG,
                           tdecode.init_kv_cache(CFG, b, max_len),
                           torch.from_numpy(lens)).numpy()
    assert np.abs(bf16 - got[0]).max() > 1e-3


# --------------------------------------------------------------- replicas


def _prompts(seed=3, prefix_len=16, extras=(3, 7, 0, 5)):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG.vocab_size, size=prefix_len).tolist()
    return [shared + rng.randint(0, CFG.vocab_size, size=int(e)).tolist()
            for e in extras]


def _drain(eng, reqs, max_steps=500):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, 'engine did not converge'


def serve_both(ref, tparams, prompts, max_new, **kwargs):
    """The same requests through the reference's ``build_engine`` (seed
    0) and the port's (``tparams``, the reference's seed-0 weights);
    returns (reference tokens, port tokens, port engine)."""
    jeng = ref.server.build_engine('debug', 2, 64, attn='xla',
                                   step_chunk=2, seed=0, **kwargs)
    jreqs = [ref.engine.Request(p, max_new) for p in prompts]
    _drain(jeng, jreqs)
    teng = model_server.build_engine('debug', 2, 64, attn='plain',
                                     step_chunk=2, device='cpu',
                                     params=tparams, **kwargs)
    treqs = [engine_lib.Request(p, max_new) for p in prompts]
    _drain(teng, treqs)
    return ([r.tokens for r in jreqs], [r.tokens for r in treqs], teng)


@pytest.mark.parametrize('kind', ['dense', 'paged', 'spec', 'chunked'])
def test_int8_replica_tokens_match_reference(ref, params, kind):
    """Paged prompts share a 16-token prefix (prefix-skipping prefill);
    chunked prefills their 16-23 tokens in chunks of 8."""
    _, tp = params
    kwargs = {'dense': {}, 'paged': {'paged': True, 'block_k': 8},
              'spec': {'paged': True, 'block_k': 8, 'spec_k': 2,
                       'drafter_layers': 1},
              'chunked': {'paged': True, 'block_k': 8,
                          'prefill_chunk': 8}}[kind]
    want, got, eng = serve_both(ref, tp, _prompts(), 6, int8=True,
                                **kwargs)
    assert got == want
    assert all(len(t) == 6 for t in got)
    if kind == 'chunked':
        # The prompts whose uncached suffix exceeds 8 tokens.
        assert eng.stats()['chunked_admissions'] > 0
    layers = eng.params['layers']
    for name in tdecode.QUANTIZED_WEIGHTS:
        assert isinstance(layers[name], tquant.QuantizedTensor)


def test_hbm_weights_count_values_scales_and_bf16_leaves(params):
    _, tp = params
    eng = model_server.build_engine('debug', 2, 64, paged=True, block_k=8,
                                    int8=True, device='cpu', params=tp)
    shapes = tllama.param_shapes(CFG)
    want = 0
    for name, shape in shapes['layers'].items():
        n = int(np.prod(shape))
        if name in tdecode.QUANTIZED_WEIGHTS:
            want += n + shape[0] * shape[2] * 4    # int8 + fp32 scales
        else:
            want += 2 * n
    want += sum(2 * int(np.prod(shapes[k]))
                for k in ('tok_embedding', 'out_norm', 'lm_head'))
    hbm = eng._hbm_accounting()  # pylint: disable=protected-access
    assert hbm['per_device_bytes']['weights'] == want
    assert engine_lib._tree_nbytes(eng.params) == want  # pylint: disable=protected-access


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the int8 library GEMM runs only '
                    'there')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 8, 16, 17, 40, 1000])
@pytest.mark.parametrize('k,n', [(4096, 1024), (14336, 512)])
def test_cuda_library_route_bit_equal_to_twin(cuda, m, k, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + k)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.02
    qw = tquant.quantize_int8(w.to(torch.bfloat16), 0)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = tquant.int8_gemm_library.launches
    got = tquant.int8_matmul(x, qw)
    assert tquant.int8_gemm_library.launches == before + 1
    want = tquant.int8_matmul_plain(x, qw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    xq, _ = tquant._quantize_rows(x)  # pylint: disable=protected-access
    assert torch.equal(tquant.int8_gemm_library(xq, qw.values),
                       tquant.int8_gemm_plain(xq, qw.values))
    with pytest.raises(ValueError, match='K-major'):
        tquant.int8_gemm_library(xq, qw.values.contiguous())
