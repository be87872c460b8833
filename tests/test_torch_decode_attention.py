"""Port decode attention (skypilot_tpu_torch/ops/decode_attention.py)
against the JAX reference (skypilot_tpu/ops/decode_attention.py).

CPU cases: the port's plain twins of the two CUDA decode kernels against
the reference's Pallas kernels (interpret mode) and XLA paths on the same
numpy inputs, fp32 at atol/rtol 2e-5 (int8 at 1e-4), mirroring
tests/unit_tests/test_decode_attention.py; ``quantize_kv`` bit for bit
the reference's under ``jax.jit``.
(The verify twin's CPU cases are in tests/test_torch_spec_decode.py.)

``cuda`` cases: the CUDA kernels against their plain twins on the card
(skipped here); the verify kernel under ``chip_smoke.py``'s
``twin_error`` rule, and bit-identical to the paged decode kernel one
query at a time. The reference is imported inside a fixture, so the card
host, which has no JAX, runs them with
``python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py``.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke
from skypilot_tpu_torch.ops import attention as t_attention
from skypilot_tpu_torch.ops import decode_attention as tda
from skypilot_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)

ATOL = RTOL = 2e-5          # fp32, as the reference's own tests
INT8_ATOL = INT8_RTOL = 1e-4


@pytest.fixture(scope='module')
def ref():
    """The JAX reference (imported here, not at module import)."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.ops import decode_attention as da
    from skypilot_tpu.ops import quant
    return types.SimpleNamespace(jnp=jnp, jax=jax, da=da, quant=quant)


def _case(seed, b, t, h, hkv, hd):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, h, hd).astype(np.float32)
    k = rng.randn(b, t, hkv, hd).astype(np.float32)
    v = rng.randn(b, t, hkv, hd).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]  # writable copy


def _paged_from_dense(dense_arrays, block_k, shuffle_seed=0, n_extra=3):
    """Scatter dense [B, T, ...] arrays (numpy or torch) into a shuffled
    block pool; returns (pools, tables [B, T // block_k] int32 numpy) —
    the layout the serving engine maintains."""
    b, t = dense_arrays[0].shape[:2]
    nb_per = t // block_k
    perm = np.random.RandomState(shuffle_seed).permutation(
        b * nb_per) + n_extra
    tables = perm.reshape(b, nb_per).astype(np.int32)
    pools = []
    for dense in dense_arrays:
        tail = tuple(dense.shape[2:])
        shape = (b * nb_per + n_extra, block_k) + tail
        # Block j of row bi is row bi * nb_per + j, as tables.reshape(-1).
        blocks = dense.reshape((b * nb_per, block_k) + tail)
        if isinstance(dense, torch.Tensor):
            pool = torch.zeros(shape, dtype=dense.dtype, device=dense.device)
            pool[torch.from_numpy(perm).to(dense.device)] = blocks
        else:
            pool = np.zeros(shape, dense.dtype)
            pool[perm] = blocks
        pools.append(pool)
    return pools, tables


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize('cur_lens', [(1, 15, 16), (17, 33, 64),
                                      (16, 31, 48)])
def test_plain_matches_reference_at_block_boundaries(ref, cur_lens):
    q, k, v = _case(0, b=3, t=64, h=8, hkv=2, hd=32)
    cur = np.array(cur_lens, np.int32)
    out = tda.decode_attention_plain(*_t(q, k, v, cur))
    jq, jk, jv, jc = (ref.jnp.asarray(a) for a in (q, k, v, cur))
    _close(out, ref.da.decode_attention_xla(jq, jk, jv, jc))
    _close(out, ref.da.decode_attention_kernel(jq, jk, jv, jc, block_k=16,
                                               interpret=True))


def test_plain_gqa_head_grouping_matches_naive_repeat(ref):
    """Query head kv*G + r reads kv head kv (the repeat_kv fan-out)."""
    q, k, v = _case(2, b=2, t=32, h=8, hkv=4, hd=16)
    cur = np.array([9, 23], np.int32)
    tq, tk, tv, tc = _t(q, k, v, cur)
    out = tda.decode_attention_plain(tq, tk, tv, tc)
    kr = t_attention.repeat_kv(tk, 2)
    vr = t_attention.repeat_kv(tv, 2)
    logits = torch.einsum('bshd,bthd->bhst', tq, kr) * 16**-0.5
    mask = torch.arange(32)[None, :] < tc[:, None].long()
    logits = torch.where(mask[:, None, None, :], logits, tda.NEG_INF)
    naive = torch.einsum('bhst,bthd->bshd', torch.softmax(logits, -1), vr)
    _close(out, naive)
    _close(out, ref.da.decode_attention_kernel(
        *(ref.jnp.asarray(a) for a in (q, k, v, cur)), block_k=16,
        interpret=True))


def test_quantize_kv_bit_exact(ref):
    """Bit for bit the reference's ``quantize_kv`` as its prefill and
    decode run it, under ``jax.jit``, at the debug pool's shapes [L,
    n_blocks, block_k, Hkv, hd]: XLA folds the scale's ``/ 127`` into
    ``* (1/127)`` there, one fp32 ulp from the eager quotient in a few
    per cent of scales (the eager reference is asserted to differ on
    this input, so the comparison discriminates)."""
    rng = np.random.RandomState(4)
    shape = (2, 6, 8, 2, 16)
    x = (rng.randn(*shape) * rng.uniform(0.01, 10, shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                         # amax floor
    x[1, 1, 1, 1, :4] = [0.5, -0.5, 1.5, -2.5]  # round-half-to-even ties
    jitted = ref.jax.jit(ref.quant.quantize_kv)
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    jq, js = jitted(ref.jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    eager = np.asarray(ref.quant.quantize_kv(ref.jnp.asarray(x))[1])
    assert (eager.view(np.uint32) != ts.numpy().view(np.uint32)).any()
    # bf16 input quantises identically too (the cache-write path).
    xb = torch.from_numpy(x).bfloat16()
    jb = ref.jnp.asarray(xb.float().numpy()).astype(ref.jnp.bfloat16)
    for got, want in zip(tquant.quantize_kv(xb), jitted(jb)):
        np.testing.assert_array_equal(
            got.numpy().view(np.uint8), np.asarray(want).view(np.uint8))


def test_plain_int8_matches_reference(ref):
    q, k, v = _case(3, b=2, t=64, h=4, hkv=2, hd=32)
    cur = np.array([31, 49], np.int32)
    kq, ks = ref.quant.quantize_kv(ref.jnp.asarray(k))
    vq, vs = ref.quant.quantize_kv(ref.jnp.asarray(v))
    arrays = [np.asarray(a) for a in (kq, vq, ks, vs)]
    tq, tk, tv, tks, tvs, tc = _t(q, *arrays, cur)
    out = tda.decode_attention_plain(tq, tk, tv, tc, tks, tvs)
    jq, jc = ref.jnp.asarray(q), ref.jnp.asarray(cur)
    _close(out, ref.da.decode_attention_xla(jq, kq, vq, jc, ks, vs),
           INT8_ATOL, INT8_RTOL)
    _close(out, ref.da.decode_attention_kernel(jq, kq, vq, jc, ks, vs,
                                               block_k=16, interpret=True),
           INT8_ATOL, INT8_RTOL)


def test_cur_len_zero_rows_are_zero(ref):
    q, k, v = _case(7, b=2, t=32, h=4, hkv=2, hd=16)
    cur = np.array([0, 20], np.int32)
    out = tda.decode_attention_plain(*_t(q, k, v, cur))
    assert float(out[0].abs().max()) == 0.0
    _close(out, ref.da.decode_attention_xla(
        *(ref.jnp.asarray(a) for a in (q, k, v, cur))))


@pytest.mark.parametrize('cur_lens', [(1, 15, 16), (17, 33, 64),
                                      (0, 31, 48)])
def test_paged_plain_matches_reference(ref, cur_lens):
    """Through a SHUFFLED table the paged twin equals the reference's
    paged kernel and dense attention on the same logical cache."""
    q, k, v = _case(8, b=3, t=64, h=8, hkv=2, hd=32)
    cur = np.array(cur_lens, np.int32)
    (kp, vp), bt = _paged_from_dense([k, v], block_k=16)
    out = tda.paged_decode_attention_plain(*_t(q, kp, vp, bt, cur))
    jq, jkp, jvp, jbt, jc = (ref.jnp.asarray(a)
                             for a in (q, kp, vp, bt, cur))
    _close(out, ref.da.paged_decode_attention_kernel(
        jq, jkp, jvp, jbt, jc, interpret=True))
    _close(out, ref.da.decode_attention_xla(
        jq, ref.jnp.asarray(k), ref.jnp.asarray(v), jc))


def test_paged_plain_int8_matches_reference(ref):
    q, k, v = _case(9, b=2, t=64, h=4, hkv=2, hd=32)
    cur = np.array([31, 49], np.int32)
    kq, ks = (np.asarray(a) for a in ref.quant.quantize_kv(
        ref.jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in ref.quant.quantize_kv(
        ref.jnp.asarray(v)))
    (kp, vp, ksp, vsp), bt = _paged_from_dense([kq, vq, ks, vs], 16)
    out = tda.paged_decode_attention_plain(*_t(q, kp, vp, bt, cur, ksp,
                                               vsp))
    jargs = [ref.jnp.asarray(a) for a in (q, kp, vp, bt, cur, ksp, vsp)]
    _close(out, ref.da.paged_decode_attention_kernel(*jargs,
                                                     interpret=True),
           INT8_ATOL, INT8_RTOL)


def test_paged_shared_blocks_read_identically():
    """Two rows whose tables name the SAME blocks read identical K/V."""
    q, k, v = _case(10, b=1, t=32, h=4, hkv=2, hd=16)
    (kp, vp), bt = _paged_from_dense([k, v], block_k=16)
    tq, tkp, tvp, tbt = _t(np.concatenate([q, q]), kp, vp,
                           np.concatenate([bt, bt]))
    out = tda.paged_decode_attention_plain(tq, tkp, tvp, tbt,
                                           torch.tensor([20, 20]))
    assert torch.equal(out[0], out[1])
    _close(out[:1], tda.decode_attention_plain(*_t(q, k, v),
                                               torch.tensor([20])))
    k_g, v_g, _, _ = tda.gather_paged_kv(tkp, tvp, tbt)
    assert torch.equal(k_g[0], torch.from_numpy(k[0]))


def test_dispatch_resolves_plain_on_cpu():
    assert tda.resolved_path('cpu') == 'plain'
    assert tda.resolved_path('cpu', 'plain') == 'plain'
    assert tda.resolved_path('cuda', 'kernel') == 'kernel'
    assert tda.resolved_path('cuda', 'plain') == 'plain'
    with pytest.raises(ValueError):
        tda.resolved_path('cpu', 'xla')
    q, k, v = _case(11, b=1, t=16, h=2, hkv=2, hd=8)
    cur = torch.tensor([7])
    before = tda.decode_attention_kernel.launches
    out = tda.decode_attention(*_t(q, k, v), cur)
    assert torch.equal(out, tda.decode_attention_plain(*_t(q, k, v), cur))
    # The plain path is not a kernel launch.
    assert tda.decode_attention_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: CPU tensors are an error."""
    q, k, v = _case(12, b=1, t=16, h=2, hkv=2, hd=8)
    with pytest.raises(ValueError, match='CUDA'):
        tda.decode_attention_kernel(*_t(q, k, v), torch.tensor([3]))


# ------------------------------------------------- split and combine (CPU)


def _row_lengths(start, s, capacity):
    """Verify row (b, i) attends positions < start[b] + 1 + i, never past
    the table: the rule of the kernels' combine."""
    return (start[:, None].long() + 1 +
            torch.arange(s)[None, :]).clamp(0, capacity)


def _split_case(seed, b=3, s=5, h=4, hkv=2, hd=16, block_k=64, n_bt=10):
    """A shuffled fp32 pool whose tables span n_bt * block_k = 640
    positions: 2.5 splits of SPLIT_SPAN."""
    rng = np.random.RandomState(seed)
    n_blocks = b * n_bt + 1
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(n_blocks, block_k, hkv, hd).astype(np.float32)
    v = rng.randn(n_blocks, block_k, hkv, hd).astype(np.float32)
    tables = (rng.permutation(b * n_bt) + 1).reshape(b, n_bt)
    return q, k, v, tables.astype(np.int32)


def _split_then_combine(q, kp, vp, bt, start, ks=None, vs=None,
                        span=tda.SPLIT_SPAN):
    k, v, gks, gvs = tda.gather_paged_kv(kp, vp, bt, ks, vs)
    row_len = _row_lengths(start, q.shape[1], k.shape[1])
    parts = tda.split_partials_plain(q, k, v, row_len, gks, gvs, span)
    return tda.combine_partials_plain(*parts, row_len, q.dtype, span)


# Row lengths start + 1 + i at the split edges of SPLIT_SPAN 256: 1-5,
# 255-259 (kSpan - 1, kSpan, kSpan + 1), 512-516 (2 kSpan + 1) and
# 637-641, capped at the table's full width 640.
@pytest.mark.parametrize('starts', [(0, 254, 511), (636, 255, 253),
                                    (511, 0, 636)])
@pytest.mark.parametrize('span', [tda.SPLIT_SPAN, 64])
def test_split_then_combine_matches_verify_twin_and_reference(ref, starts,
                                                              span):
    """The kernels' split partials and combine, as plain twins, give the
    verify twin and the reference's XLA verify at fp32."""
    q, k, v, bt = _split_case(20)
    start = np.array(starts, np.int32)
    args = _t(q, k, v, bt, start)
    out = _split_then_combine(*args, span=span)
    _close(out, tda.paged_verify_attention_plain(*args))
    _close(out, ref.da.paged_verify_attention_xla(
        *(ref.jnp.asarray(a) for a in (q, k, v, bt, start))))


def test_split_then_combine_int8_matches_reference(ref):
    q, k, v, bt = _split_case(21, s=3)
    start = np.array([255, 510, 637], np.int32)
    kq, ks = (np.asarray(a) for a in ref.quant.quantize_kv(
        ref.jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in ref.quant.quantize_kv(
        ref.jnp.asarray(v)))
    arrays = (q, kq, vq, bt, start, ks, vs)
    out = _split_then_combine(*_t(*arrays))
    _close(out, ref.da.paged_verify_attention_xla(
        *(ref.jnp.asarray(a) for a in arrays)), INT8_ATOL, INT8_RTOL)
    _close(out, tda.paged_verify_attention_plain(*_t(*arrays)), INT8_ATOL,
           INT8_RTOL)


@pytest.mark.parametrize('cur_lens', [(0, 1, 255), (256, 257, 513),
                                      (640, 300, 0)])
def test_split_then_combine_one_query_is_the_decode_twin(ref, cur_lens):
    """S = 1: the split path at start = cur_len - 1 is the paged and
    dense decode twins at cur_len (a length-0 row comes out zero)."""
    q, k, v, bt = _split_case(22, s=1)
    cur = np.array(cur_lens, np.int32)
    tq, tk, tv, tbt, tc = _t(q, k, v, bt, cur)
    out = _split_then_combine(tq, tk, tv, tbt, tc - 1)
    _close(out, tda.paged_decode_attention_plain(tq, tk, tv, tbt, tc))
    kd, vd, _, _ = tda.gather_paged_kv(tk, tv, tbt)
    _close(out, tda.decode_attention_plain(tq, kd, vd, tc))
    _close(out, ref.da.decode_attention_xla(
        *(ref.jnp.asarray(a) for a in (q, kd.numpy(), vd.numpy(), cur))))
    for row, n in enumerate(cur_lens):
        if n == 0:
            assert float(out[row].abs().max()) == 0.0


def test_split_partials_of_one_split_are_its_softmax_pieces():
    """A row that fits one split: m is its largest logit, acc / l its
    attention output; the splits past it are empty (NEG_INF, 0, 0)."""
    q, k, v, bt = _split_case(23, b=1, s=1)
    tq, tk, tv, tbt = _t(q, k, v, bt)
    kd, vd, _, _ = tda.gather_paged_kv(tk, tv, tbt)
    row_len = torch.tensor([[200]])
    m, l, acc = tda.split_partials_plain(tq, kd, vd, row_len)
    assert m.shape == (1, 1, 4, 3) and acc.shape == (1, 1, 4, 3, 16)
    logits = torch.einsum('bshd,bthd->bsht', tq,
                          t_attention.repeat_kv(kd, 2)[:, :200]) * 16**-0.5
    _close(m[..., 0], logits.amax(-1))
    _close(acc[..., 0, :] / l[..., 0, None],
           tda.decode_attention_plain(tq, kd, vd, torch.tensor([200])))
    assert torch.all(m[..., 1:] == tda.NEG_INF)
    assert torch.all(l[..., 1:] == 0) and torch.all(acc[..., 1:, :] == 0)


def test_combine_reads_no_split_past_the_row_length():
    """Partials of splits that start at or past a row's length are never
    read: NaN there leaves the output as it was."""
    q, k, v, bt = _split_case(24, s=2)
    tq, tk, tv, tbt = _t(q, k, v, bt)
    kd, vd, _, _ = tda.gather_paged_kv(tk, tv, tbt)
    row_len = torch.tensor([[255, 256], [257, 300], [0, 640]])
    m, l, acc = tda.split_partials_plain(tq, kd, vd, row_len)
    want = tda.combine_partials_plain(m, l, acc, row_len, torch.float32)
    dead = (torch.arange(3)[None, None, :] * tda.SPLIT_SPAN >=
            row_len[:, :, None])[:, :, None, :].expand_as(m)
    m, l = m.masked_fill(dead, float('nan')), l.masked_fill(dead,
                                                            float('nan'))
    acc = acc.masked_fill(dead[..., None], float('nan'))
    got = tda.combine_partials_plain(m, l, acc, row_len, torch.float32)
    assert torch.equal(got, want)
    assert float(got[2, 0].abs().max()) == 0.0


def test_tensor_core_dispatch_rule():
    """By dtype and shape only: bf16 q over a bf16 or int8 cache at
    head_dim % 16 == 0 takes the mma body (llama3-8b's serving path),
    everything else the CUDA-core body."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert tda.uses_tensor_cores(bf16, bf16, 128)
    assert tda.uses_tensor_cores(bf16, i8, 128)
    assert tda.uses_tensor_cores(bf16, bf16, 64)
    assert tda.uses_tensor_cores(bf16, bf16, 256)
    assert not tda.uses_tensor_cores(bf16, bf16, 36)
    assert not tda.uses_tensor_cores(bf16, i8, 40)
    assert not tda.uses_tensor_cores(bf16, f32, 128)
    assert not tda.uses_tensor_cores(f32, f32, 128)
    assert not tda.uses_tensor_cores(f32, i8, 128)


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels run only there')
    return torch.device('cuda')


def _cuda_case(dev, seed, b, t, h, hkv, hd, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, 1, h, hd), (b, t, hkv, hd),
                             (b, t, hkv, hd)))
    return q, k, v


# fp32 kernel vs fp32 plain: only the summation order differs. bf16:
# the plain twin rounds probabilities to bf16 before PV, the kernel does
# not, so they differ by a few bf16 ulps of outputs of magnitude <~ 4.
_CUDA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('hd', [64, 36])   # 36: rows not 16-byte aligned
def test_cuda_dense_kernel_matches_plain(cuda, dtype, int8, hd):
    q, k, v = _cuda_case(cuda, 0, b=6, t=256, h=8, hkv=2, hd=hd,
                         dtype=dtype)
    cur = torch.tensor([0, 1, 63, 64, 65, 256], device=cuda)
    scales = ()
    if int8:
        k, ks = tquant.quantize_kv(k)
        v, vs = tquant.quantize_kv(v)
        scales = (ks, vs)
    before = tda.decode_attention_kernel.launches
    out = tda.decode_attention_kernel(q, k, v, cur, *scales)
    torch.cuda.synchronize()
    assert tda.decode_attention_kernel.launches == before + 1
    ref_out = tda.decode_attention_plain(q, k, v, cur, *scales)
    assert float(out[0].abs().max()) == 0.0
    tol = max(_CUDA_TOL[dtype], INT8_ATOL if int8 else 0.0)
    _close(out.float().cpu(), ref_out.float().cpu(), tol, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('int8', [False, True])
def test_cuda_paged_kernel_matches_plain(cuda, int8):
    """Shuffled tables, and two rows naming the same blocks."""
    q, k, v = _cuda_case(cuda, 1, b=4, t=128, h=16, hkv=4, hd=128,
                         dtype=torch.bfloat16)
    cur = torch.tensor([128, 17, 100, 0], device=cuda)
    dense = [k, v]
    if int8:
        k8, ks = tquant.quantize_kv(k)
        v8, vs = tquant.quantize_kv(v)
        dense = [k8, v8, ks, vs]
    pools, tables = _paged_from_dense(dense, block_k=32)
    tables[2] = tables[0]                     # rows 0 and 2 share blocks
    tables = torch.from_numpy(tables).to(cuda)
    out = tda.paged_decode_attention_kernel(q, pools[0], pools[1], tables,
                                            cur, *pools[2:])
    torch.cuda.synchronize()
    ref_out = tda.paged_decode_attention_plain(q, pools[0], pools[1],
                                               tables, cur, *pools[2:])
    _close(out.float().cpu(), ref_out.float().cpu(),
           _CUDA_TOL[torch.bfloat16], _CUDA_TOL[torch.bfloat16])
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _cuda_case(cuda, 2, b=1, t=16, h=2, hkv=1, hd=320,
                         dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='hd <='):
        tda.decode_attention_kernel(q, k, v, torch.tensor([3], device=cuda))
    q, k, v = _cuda_case(cuda, 2, b=1, t=16, h=2, hkv=1, hd=64,
                         dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='int8'):
        tda.decode_attention_kernel(q, k, v, torch.tensor([3], device=cuda),
                                    torch.ones(1, 16, 1, device=cuda),
                                    torch.ones(1, 16, 1, device=cuda))


def _verify_cuda_case(dev, seed, b, s, h, hkv, hd, block_k, max_blocks,
                      dtype, int8):
    """q [B,S,H,hd] and a shuffled pool covering B x max_blocks blocks
    (+ scratch block 0); rows 0 and 2 name the same blocks."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_pool = b * max_blocks + 1
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    kv = [torch.randn(n_pool, block_k, hkv, hd, generator=gen,
                      device=dev).to(dtype) for _ in range(2)]
    pools = kv
    if int8:
        (k8, ks), (v8, vs) = (tquant.quantize_kv(x) for x in kv)
        pools = [k8, v8, ks, vs]
    tables = (torch.randperm(b * max_blocks, generator=gen, device=dev)
              + 1).reshape(b, max_blocks).to(torch.int32)
    tables[2] = tables[0]
    return q, pools, tables


@pytest.mark.cuda
@pytest.mark.parametrize('s', [1, 5, 9])
@pytest.mark.parametrize('dtype,int8', [(torch.bfloat16, False),
                                        (torch.bfloat16, True),
                                        (torch.float32, False)])
def test_cuda_verify_kernel_matches_plain_and_decode(cuda, s, dtype, int8):
    """Verify kernel vs its twin (chip_smoke.twin_error), starts at block
    edges and past the table (126 + S > max_len 128); query i bit-equal
    to the paged decode kernel at cur_len = start + i + 1."""
    q, pools, tables = _verify_cuda_case(cuda, 3, b=4, s=s, h=16, hkv=4,
                                         hd=128, block_k=32, max_blocks=4,
                                         dtype=dtype, int8=int8)
    start = torch.tensor([0, 31, 126, 100], dtype=torch.int32, device=cuda)
    before = tda.paged_verify_attention_kernel.launches
    out = tda.paged_verify_attention_kernel(q, pools[0], pools[1], tables,
                                            start, *pools[2:])
    torch.cuda.synchronize()
    assert tda.paged_verify_attention_kernel.launches == before + 1
    want = tda.paged_verify_attention_plain(q, pools[0], pools[1], tables,
                                            start, *pools[2:])
    assert out.shape == want.shape and out.dtype == dtype
    err, msg = chip_smoke.twin_error(
        out, want, 'fp32' if dtype == torch.float32 else 'bf16')
    assert err is None, msg
    for i in range(s):
        dec = tda.paged_decode_attention_kernel(
            q[:, i:i + 1].contiguous(), pools[0], pools[1], tables,
            start + i + 1, *pools[2:])
        assert torch.equal(out[:, i:i + 1], dec), i


@pytest.mark.cuda
def test_cuda_verify_kernel_rejects_what_it_does_not_take(cuda):
    q, pools, tables = _verify_cuda_case(cuda, 4, b=3, s=3, h=8, hkv=2,
                                         hd=64, block_k=16, max_blocks=2,
                                         dtype=torch.bfloat16, int8=False)
    start = torch.tensor([3, 9, 0], device=cuda)
    with pytest.raises(ValueError, match='CUDA'):
        tda.paged_verify_attention_kernel(q.cpu(), pools[0].cpu(),
                                          pools[1].cpu(), tables.cpu(),
                                          start.cpu())
    with pytest.raises(ValueError, match='dtype'):
        tda.paged_verify_attention_kernel(q.half(), pools[0], pools[1],
                                          tables, start)
    with pytest.raises(ValueError, match='dtypes'):
        tda.paged_verify_attention_kernel(q, pools[0].half(),
                                          pools[1].half(), tables, start)
    with pytest.raises(ValueError, match='block_tables'):
        tda.paged_verify_attention_kernel(q, pools[0], pools[1],
                                          tables.cpu(), start)


# Split edges of the kernels' fixed span, and the table's full width
# (640 = 2.5 spans: the last split is cut by the capacity).
SPAN = tda.SPLIT_SPAN
SPLIT_EDGE_LENS = [0, 1, SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 1, 640]
_SPLIT_CASES = [(torch.bfloat16, False), (torch.bfloat16, True),
                (torch.float32, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [128, 64, 36])
@pytest.mark.parametrize('dtype,int8', _SPLIT_CASES)
def test_cuda_dense_kernel_at_split_edges(cuda, hd, dtype, int8):
    """Dense decode at every split edge against its twin, and two
    launches bitwise equal (hd 36 takes the CUDA-core body)."""
    q, k, v = _cuda_case(cuda, 5, b=len(SPLIT_EDGE_LENS), t=640, h=8,
                         hkv=2, hd=hd, dtype=dtype)
    cur = torch.tensor(SPLIT_EDGE_LENS, device=cuda)
    scales = ()
    if int8:
        k, ks = tquant.quantize_kv(k)
        v, vs = tquant.quantize_kv(v)
        scales = (ks, vs)
    out = tda.decode_attention_kernel(q, k, v, cur, *scales)
    again = tda.decode_attention_kernel(q, k, v, cur, *scales)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float(out[0].abs().max()) == 0.0
    ref_out = tda.decode_attention_plain(q, k, v, cur, *scales)
    tol = max(_CUDA_TOL[dtype], INT8_ATOL if int8 else 0.0)
    _close(out.float().cpu(), ref_out.float().cpu(), tol, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('int8', [False, True])
def test_cuda_paged_kernel_at_split_edges(cuda, int8):
    q, pools, tables = _verify_cuda_case(
        cuda, 6, b=len(SPLIT_EDGE_LENS), s=1, h=32, hkv=8, hd=128,
        block_k=64, max_blocks=10, dtype=torch.bfloat16, int8=int8)
    cur = torch.tensor(SPLIT_EDGE_LENS, device=cuda)
    out = tda.paged_decode_attention_kernel(q, pools[0], pools[1], tables,
                                            cur, *pools[2:])
    again = tda.paged_decode_attention_kernel(q, pools[0], pools[1],
                                              tables, cur, *pools[2:])
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float(out[0].abs().max()) == 0.0
    ref_out = tda.paged_decode_attention_plain(q, pools[0], pools[1],
                                               tables, cur, *pools[2:])
    _close(out.float().cpu(), ref_out.float().cpu(),
           _CUDA_TOL[torch.bfloat16], _CUDA_TOL[torch.bfloat16])


# Verify rows start + 1 + i cross the split edges 256 and 512 and run
# into the table's width 640.
SPLIT_EDGE_STARTS = [0, SPAN - 3, SPAN - 1, 2 * SPAN - 4, 2 * SPAN, 638]


@pytest.mark.cuda
@pytest.mark.parametrize('s', [1, 5, 9, 17])
@pytest.mark.parametrize('dtype,int8', _SPLIT_CASES)
def test_cuda_verify_kernel_at_split_edges(cuda, s, dtype, int8):
    """S up to 17 (G 4: 68 rows, five row chunks): the twin rule, two
    launches bitwise equal, and query i bitwise equal to the paged
    decode kernel at cur_len = start + i + 1."""
    q, pools, tables = _verify_cuda_case(
        cuda, 7, b=len(SPLIT_EDGE_STARTS), s=s, h=16, hkv=4, hd=128,
        block_k=64, max_blocks=10, dtype=dtype, int8=int8)
    start = torch.tensor(SPLIT_EDGE_STARTS, dtype=torch.int32, device=cuda)
    args = (q, pools[0], pools[1], tables, start, *pools[2:])
    out = tda.paged_verify_attention_kernel(*args)
    again = tda.paged_verify_attention_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err, msg = chip_smoke.twin_error(
        out, tda.paged_verify_attention_plain(*args),
        'fp32' if dtype == torch.float32 else 'bf16')
    assert err is None, msg
    for i in range(s):
        dec = tda.paged_decode_attention_kernel(
            q[:, i:i + 1].contiguous(), pools[0], pools[1], tables,
            start + i + 1, *pools[2:])
        assert torch.equal(out[:, i:i + 1], dec), i


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,int8', _SPLIT_CASES)
def test_cuda_partials_and_combine_match_their_twins(cuda, dtype, int8):
    """The split kernel's workspace against split_partials_plain on the
    live splits, and the output against combine_partials_plain on the
    kernel's own partials."""
    s, block_k, max_blocks = 5, 64, 10
    q, pools, tables = _verify_cuda_case(
        cuda, 8, b=len(SPLIT_EDGE_STARTS), s=s, h=16, hkv=4, hd=128,
        block_k=block_k, max_blocks=max_blocks, dtype=dtype, int8=int8)
    start = torch.tensor(SPLIT_EDGE_STARTS, dtype=torch.int32, device=cuda)
    scales = pools[2:] if int8 else (None, None)
    parts = {}
    out = tda._launch(q, pools[0], pools[1], *scales, start, tables,
                      block_k=block_k, max_blocks=max_blocks,
                      n_pool_blocks=pools[0].shape[0], verify=True,
                      partials=parts)
    torch.cuda.synchronize()
    cap = block_k * max_blocks
    row_len = (start[:, None].long() + 1 +
               torch.arange(s, device=cuda)[None, :]).clamp(0, cap)
    rule = 'fp32' if dtype == torch.float32 else 'bf16'
    err, msg = chip_smoke.twin_error(
        out, tda.combine_partials_plain(parts['m'], parts['l'],
                                        parts['acc'], row_len, dtype),
        rule)
    assert err is None, msg
    k, v, ks, vs = tda.gather_paged_kv(pools[0], pools[1], tables,
                                       *pools[2:])
    m, l, acc = tda.split_partials_plain(q, k, v, row_len, ks, vs)
    live = (torch.arange(m.shape[-1], device=cuda)[None, None, :] * SPAN <
            row_len[:, :, None])[:, :, None, :].expand_as(m)
    _close(parts['m'][live].cpu(), m[live].cpu(), 1e-4, 1e-5)
    _close(parts['l'][live].cpu(), l[live].cpu(), 1e-4, 1e-4)
    err, msg = chip_smoke.twin_error(
        parts['acc'][live] / parts['l'][live][:, None],
        acc[live] / l[live][:, None], rule)
    assert err is None, msg


@pytest.mark.cuda
def test_cuda_dispatch_rule_is_the_libraries(cuda):
    """The launcher's body choice equals uses_tensor_cores on every
    dtype pair and head_dim the kernels take."""
    uses_mma = tda._library().skytorch_decode_attention_uses_mma
    codes = tda._DTYPE_CODES
    for q_dtype in (torch.float32, torch.bfloat16):
        for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
            for hd in range(1, tda.MAX_HEAD_DIM + 1):
                assert (bool(uses_mma(codes[q_dtype], codes[kv_dtype], hd))
                        == tda.uses_tensor_cores(q_dtype, kv_dtype, hd)), (
                            q_dtype, kv_dtype, hd)
