"""Port flash attention (skypilot_tpu_torch/ops/flash_attention.py)
against the JAX reference (skypilot_tpu/ops/flash_attention.py).

CPU cases: the port's plain twins of the three CUDA kernels against the
reference's Pallas kernels in interpret mode (``_flash_forward``,
``_flash_backward``), against ``jax.grad`` of ``flash_attention``, and
against its dense fallback where S does not tile; the autograd Function
against autograd through the plain ``gqa_attention``. Inputs come from
numpy seeds. Tolerances as tests/unit_tests/test_flash_attention.py:
2e-5 forward, 2e-4 gradients, fp32.

``cuda`` cases: each CUDA kernel against its plain twin on the card
(skipped here), under ``chip_smoke.py``'s bounds (its ``twin_error``),
whose bf16 rule has a CPU test of its own; the bf16 wgmma forward and
backward at every tile edge, launched twice for the same bits. CPU
cases also cover which library each pass and dtype launch
(``kernel_entry``), the build's sources and digest, and ``row_dot``.
The reference is imported inside a fixture, so the card host, which
has no JAX, runs them with
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""
import shutil
import types

import numpy as np
import pytest
import torch

import chip_smoke
from skypilot_tpu_torch.ops import attention as t_attention
from skypilot_tpu_torch.ops import cuda_build
from skypilot_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

FWD_TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture(scope='module')
def ref():
    """The JAX reference (imported here, not at module import)."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.ops import attention
    from skypilot_tpu.ops import flash_attention as fa
    return types.SimpleNamespace(jax=jax, jnp=jnp, fa=fa,
                                 attention=attention)


def _case(seed, b, s, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


# (b, s, h, hkv, d, causal, block): MHA both ways, GQA fan-out, blocks
# larger than S (clamped to S by the reference).
TILED = [(2, 64, 4, 4, 16, True, 32), (2, 64, 4, 4, 16, False, 32),
         (2, 64, 8, 2, 16, True, 32), (1, 32, 2, 2, 8, True, 256)]


@pytest.mark.parametrize('b,s,h,hkv,d,causal,block', TILED)
def test_forward_twin_matches_pallas_kernel(ref, b, s, h, hkv, d, causal,
                                            block):
    q, k, v, _ = _case(0, b, s, h, hkv, d)
    out, lse = ref.fa._flash_forward(  # pylint: disable=protected-access
        *(ref.jnp.asarray(a) for a in (q, k, v)), causal, block, block,
        True)
    t_out, t_lse = tfa.flash_forward_plain(*_t(q, k, v), causal)
    _close(t_out.numpy(), out, FWD_TOL)
    _close(t_lse.reshape(b * h, s).numpy(), lse, FWD_TOL)


@pytest.mark.parametrize('b,s,h,hkv,d,causal,block', TILED)
def test_backward_twin_matches_pallas_kernels(ref, b, s, h, hkv, d, causal,
                                              block):
    q, k, v, g = _case(1, b, s, h, hkv, d)
    jq, jk, jv, jg = (ref.jnp.asarray(a) for a in (q, k, v, g))
    out, lse = ref.fa._flash_forward(  # pylint: disable=protected-access
        jq, jk, jv, causal, block, block, True)
    grads = ref.fa._flash_backward(  # pylint: disable=protected-access
        jq, jk, jv, out, lse, jg, causal, block, block, True)
    t_grads = tfa.flash_backward_plain(
        *_t(q, k, v, np.asarray(out)),
        torch.from_numpy(np.array(lse)).reshape(b, h, s),
        torch.from_numpy(g), causal)
    for t_x, x in zip(t_grads, grads):
        assert t_x.shape == x.shape
        _close(t_x.numpy(), x, GRAD_TOL)


def _port_grads(q, k, v, w, causal):
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize('s,block,causal', [(64, 32, True), (64, 32, False),
                                            (50, 32, True)])
def test_gradients_match_jax_grad(ref, s, block, causal):
    """Through the autograd Function; at S=50 the reference does not tile
    and runs its dense fallback, the port's kernels mask the tail."""
    q, k, v, w = _case(2, 2, s, 8, 2, 16)
    jw = ref.jnp.asarray(w)

    def loss(q_, k_, v_):
        out = ref.fa.flash_attention(q_, k_, v_, causal, block, block, True)
        return (out * jw).sum()

    jargs = [ref.jnp.asarray(a) for a in (q, k, v)]
    out = ref.fa.flash_attention(*jargs, causal, block, block, True)
    grads = ref.jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    t_out, t_grads = _port_grads(q, k, v, w, causal)
    _close(t_out.numpy(), out, FWD_TOL)
    for t_x, x in zip(t_grads, grads):
        _close(t_x.numpy(), x, GRAD_TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_function_gradients_match_autograd_of_gqa_attention(causal):
    q, k, v, w = _case(3, 2, 40, 6, 3, 8)
    t_out, t_grads = _port_grads(q, k, v, w, causal)
    rq, rk, rv = (x.requires_grad_(True) for x in _t(q, k, v))
    ref_out = t_attention.gqa_attention(rq, rk, rv, causal=causal)
    (ref_out * torch.from_numpy(w)).sum().backward()
    _close(t_out.numpy(), ref_out.detach().numpy(), FWD_TOL)
    for t_x, x in zip(t_grads, (rq.grad, rk.grad, rv.grad)):
        _close(t_x.numpy(), x.numpy(), GRAD_TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_row_dot_is_exact_and_leaves_its_inputs(dtype):
    """D = rowsum(dO ⊙ O) as [B,H,S] in fp32, with the products exact
    (a bf16 product fits in fp32); dO is not written, though an fp32 dO
    is where ``.float()`` would return it and not a copy."""
    _, _, _, g = _case(6, 2, 24, 6, 3, 16)
    out = _case(7, 2, 24, 6, 3, 16)[0]
    dout, o = (torch.from_numpy(x).to(dtype) for x in (g, out))
    before = dout.clone()
    got = tfa.row_dot(dout, o)
    assert torch.equal(dout, before)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 24)
    want = (dout.double() * o.double()).sum(-1).transpose(1, 2)
    _close(got.numpy(), want.numpy(), 1e-6)


def test_dispatch_takes_plain_only_on_cpu_or_when_asked():
    assert tfa.resolved_path('cpu') == 'plain'
    assert tfa.resolved_path('cpu', 'kernel') == 'plain'
    assert tfa.resolved_path('cuda') == 'kernel'
    assert tfa.resolved_path('cuda', 'kernel') == 'kernel'
    assert tfa.resolved_path('cuda', 'plain') == 'plain'
    with pytest.raises(ValueError, match='impl'):
        tfa.resolved_path('cuda', 'xla')
    # The kernel wrappers never run the twin: CPU tensors are refused.
    q, k, v, g = _t(*_case(4, 1, 8, 2, 1, 64))
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_forward_kernel(q, k, v)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_bwd_dq_kernel(q, k, v, g, lse, lse)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, lse)
    assert [fn.launches for fn in tfa.KERNELS] == [0, 0, 0]


@pytest.mark.parametrize('kernel_pass', tfa.PASSES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_kernel_entry_picks_the_library_by_dtype(kernel_pass, dtype):
    """bf16 launches the wgmma kernels, fp32 the CUDA-core bodies of
    flash_attention.cu; each launcher's library is a built source that
    defines its C symbol."""
    name = tfa.kernel_entry(kernel_pass, dtype)
    lib, symbol, _ = tfa.ENTRIES[name]
    if dtype == torch.bfloat16:
        assert name == f'{kernel_pass}_wgmma'
        assert lib == ('flash_forward_wgmma' if kernel_pass == 'forward'
                       else 'flash_backward_wgmma')
    else:
        assert (name, lib) == (kernel_pass, 'flash_attention')
    source = (cuda_build.CSRC_DIR / cuda_build.SOURCES[lib]).read_text()
    assert f'extern "C" int {symbol}(' in source


def test_kernel_entry_refuses_other_dtypes_and_passes():
    with pytest.raises(ValueError, match='no flash attention kernel'):
        tfa.kernel_entry('dq', torch.float16)
    with pytest.raises(ValueError, match='no flash attention kernel'):
        tfa.kernel_entry('backward', torch.bfloat16)


def test_build_sources_hold_the_backward_wgmma_library():
    """The bf16 backward's source is built with the others, and both
    wgmma sources take their Hopper helpers from the shared header."""
    assert cuda_build.SOURCES['flash_backward_wgmma'] == (
        'flash_backward_wgmma.cu')
    assert {lib for lib, _, _ in tfa.ENTRIES.values()} <= set(
        cuda_build.SOURCES)
    for name in ('flash_forward_wgmma', 'flash_backward_wgmma'):
        source = (cuda_build.CSRC_DIR / cuda_build.SOURCES[name]).read_text()
        assert '#include "hopper.cuh"' in source


def test_library_digest_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit of csrc/hopper.cuh renames every library, so a stale
    build of either wgmma source is never loaded."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', csrc)
    before = {name: cuda_build.library_path(name)
              for name in cuda_build.SOURCES}
    header = csrc / 'hopper.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    after = {name: cuda_build.library_path(name)
             for name in cuda_build.SOURCES}
    for name in cuda_build.SOURCES:
        assert after[name] != before[name]
        assert after[name].name.startswith(f'lib{name}_')


# ------------------------------------------------------------------- cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels run only there')
    return torch.device('cuda')


def _cuda_case(dev, seed, b, s, h, hkv, d, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, h, d))]


def _check_twin(got, want, dtype):
    """chip_smoke.py's rule for a kernel against its twin. fp32: within
    2e-5 of the twin's largest |value|. bf16 (the kernels round P and dS
    to bf16 before the second product, the twins keep fp32): every
    element within one bf16 ulp plus 2e-2 of its row's scale, and the
    tensor within 5e-3 in relative norm."""
    err, msg = chip_smoke.twin_error(
        got, want, 'fp32' if dtype == torch.float32 else 'bf16')
    assert err is None, msg


def test_bf16_twin_rule_rejects_a_wrong_softmax_scale():
    """The bf16 rule passes a correct output computed another way and
    fails one whose softmax scale is 1% off, which the older rule (max
    error within 1e-2 of the largest |value|) let through."""
    q, k, v, _ = (torch.from_numpy(a).bfloat16()
                  for a in _case(5, 1, 256, 4, 2, 64))
    want = tfa.flash_forward_plain(q, k, v)[0]
    qf, kf, vf = q.float(), k.float(), v.float()
    other = t_attention.gqa_attention(qf, kf, vf, causal=True).bfloat16()
    _check_twin(other, want, torch.bfloat16)
    wrong = tfa.flash_forward_plain(qf * 1.01, kf, vf)[0].bfloat16()
    assert ((wrong.float() - want.float()).abs().max() <=
            1e-2 * want.float().abs().max())
    with pytest.raises(AssertionError):
        _check_twin(wrong, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,s,h,hkv,d,causal', [
    (2, 256, 8, 2, 64, True), (2, 200, 4, 4, 128, False),
    (1, 1000, 16, 8, 128, True), (3, 70, 6, 2, 64, True)])
def test_cuda_kernels_match_plain(cuda, dtype, b, s, h, hkv, d, causal):
    q, k, v, g = _cuda_case(cuda, 0, b, s, h, hkv, d, dtype)
    out, lse = tfa.flash_forward_kernel(q, k, v, causal)
    dsum = tfa.row_dot(g, out)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum, causal)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal)
    torch.cuda.synchronize()
    p_out, p_lse = tfa.flash_forward_plain(q, k, v, causal)
    _check_twin(out, p_out, dtype)
    assert (lse - p_lse).abs().max().item() <= 1e-4
    for got, want in zip((dq, dk, dv), tfa.flash_backward_plain(
            q, k, v, out, lse, g, causal)):
        assert got.dtype == dtype and got.shape == want.shape
        _check_twin(got, want, dtype)


@pytest.mark.cuda
def test_cuda_function_launches_each_kernel(cuda):
    q, k, v, g = _cuda_case(cuda, 1, 2, 128, 4, 2, 64, torch.bfloat16)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    tfa.reset_launch_counts()
    out = tfa.flash_attention(q, k, v)
    out.backward(g)
    torch.cuda.synchronize()
    assert [fn.launches for fn in tfa.KERNELS] == [1, 1, 1]
    with pytest.raises(ValueError, match='head_dim'):
        tfa.flash_forward_kernel(*(x.detach()[..., :32] for x in (q, k, v)))


# The bf16 forward's tile edges: its CTAs hold 128 query rows and walk
# K/V tiles of 128 keys.
WGMMA_SEQS = (1, 63, 64, 65, 127, 128, 129, 1000, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize('g', [1, 2, 8])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('s', WGMMA_SEQS)
def test_cuda_bf16_forward_at_tile_edges(cuda, s, d, causal, g):
    """The wgmma forward against its twin (out under ``twin_error``, LSE
    within 1e-4), the same bits on a second launch, and the backward
    kernels run on its LSE against the backward twin."""
    q, k, v, dout = _cuda_case(cuda, 7, 2, s, 2 * g, 2, d, torch.bfloat16)
    out, lse = tfa.flash_forward_kernel(q, k, v, causal)
    again, lse_again = tfa.flash_forward_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    p_out, p_lse = tfa.flash_forward_plain(q, k, v, causal)
    _check_twin(out, p_out, torch.bfloat16)
    assert (lse - p_lse).abs().max().item() <= 1e-4
    dsum = tfa.row_dot(dout, out)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, dout, lse, dsum, causal)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, dout, lse, dsum, causal)
    want = tfa.flash_backward_plain(q, k, v, out, lse, dout, causal)
    for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        if s == 1 and name != 'dv':
            # One key: softmax has no gradient, so dq and dk are 0 and
            # both sides hold only fp32 rounding of dP - D (~1e-6).
            assert got.float().abs().max().item() <= 1e-4
            assert ref.float().abs().max().item() <= 1e-4
        else:
            _check_twin(got, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('g', [1, 2, 8])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('s', WGMMA_SEQS + (70,))
def test_cuda_bf16_backward_at_tile_edges(cuda, s, d, causal, g):
    """The wgmma backward kernels (dq CTAs of 128 query rows over 64-key
    tiles, dk/dv CTAs of 128 keys over 64-row query tiles of G heads)
    against the backward twin under ``twin_error``, and the same bits on
    a second launch."""
    q, k, v, dout = _cuda_case(cuda, 9, 2, s, 2 * g, 2, d, torch.bfloat16)
    out, lse = tfa.flash_forward_kernel(q, k, v, causal)
    dsum = tfa.row_dot(dout, out)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, dout, lse, dsum, causal)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, dout, lse, dsum, causal)
    dq_again = tfa.flash_bwd_dq_kernel(q, k, v, dout, lse, dsum, causal)
    dk_again, dv_again = tfa.flash_bwd_dkv_kernel(q, k, v, dout, lse, dsum,
                                                  causal)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq_again)
    assert torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
    want = tfa.flash_backward_plain(q, k, v, out, lse, dout, causal)
    for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        if s == 1 and name != 'dv':
            # One key: dq and dk are 0 up to fp32 rounding of dP - D.
            assert got.float().abs().max().item() <= 1e-4
            assert ref.float().abs().max().item() <= 1e-4
        else:
            _check_twin(got, ref, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_each_library_takes_only_its_dtype(cuda):
    """flash_attention.cu refuses bf16 (-1) and the wgmma libraries
    refuse fp32, before any launch; so fp32 dq/dk/dv, which match their
    twin, ran the CUDA-core kernels."""
    q, k, v, g = _cuda_case(cuda, 3, 1, 96, 4, 2, 64, torch.float32)
    out, lse = tfa.flash_forward_kernel(q, k, v)
    dsum = tfa.row_dot(g, out)
    scratch = [torch.empty_like(x) for x in (q, k, v)]
    buffers = {'forward': (q, k, v, scratch[0], lse),
               'dq': (q, k, v, g, lse, dsum, scratch[0]),
               'dkv': (q, k, v, g, lse, dsum, scratch[1], scratch[2])}
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in tfa._entries().items():  # pylint: disable=protected-access
        tensors = buffers[name.split('_')[0]]
        wrong = 0 if name.endswith('_wgmma') else 1
        assert fn(*(t.data_ptr() for t in tensors), wrong, 1, 96, 4, 2, 64,
                  1, 0.125, stream) == -1, name
    dq = tfa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), tfa.flash_backward_plain(
            q, k, v, out, lse, g, True)):
        assert got.dtype == torch.float32
        _check_twin(got, want, torch.float32)
