"""Time the bf16 flash backward kernels against design variants, on the card.

Run from the root of a checkout on a machine with an H100:

    python3 -m skypilot_tpu_torch.tools.flash_backward_variants \
        [--forward-parent OLD_flash_forward_wgmma.cu]

Each variant is an edited copy of ``csrc/flash_backward_wgmma.cu``, built
with ``cuda_build.NVCC_FLAGS`` into ``build/dev/`` (gitignored) and
loaded with ctypes beside the committed library:

* ``committed``: the source as it is;
* ``dq_two_stages``: dq's K/V ring of two stages instead of three;
* ``dkv_overlap``: dk/dv issuing step t's Sᵀ/dPᵀ with step t-1's dV/dK
  products (as dq does), three stages, 24/240 registers;
* ``split_issue``: each warpgroup forms P while dP is on the tensor
  cores, and dk/dv issues Pᵀ·dO before forming dS.

At the training shapes (B 12, S 2048, H 16, Hkv 8, D 128, causal) it
prints each variant's ptxas registers and spills, its dq and dk/dv ms in
three rounds taken in turns (events around 20 calls), TFLOP/s and share
of the operations bound, and whether its outputs hold the committed
kernels' bits (else their ``twin_error`` against the plain twin). Then
``row_dot`` against the einsum over two fp32 copies that it replaced,
the committed pair (``row_dot``, dq, dk/dv) and SDPA's backward.
``--forward-parent`` compiles an older ``flash_forward_wgmma.cu`` beside
the committed one and reports whether their SASS is identical.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke
from skypilot_tpu_torch.ops import cuda_build
from skypilot_tpu_torch.ops import flash_attention as fa

DEV_DIR = cuda_build.BUILD_DIR.parent / 'dev'
SHAPES = (12, 2048, 16, 8, 128, True)   # B, S, H, Hkv, D, causal


def _edit(text, *pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f'variant edit does not apply: {old[:60]!r}')
        text = text.replace(old, new)
    return text


_DKV_LOOP_START = '''    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    for (int t = 0; t < n_steps; ++t) {
      const int st = t % kDkvStages;'''
_DKV_LOOP_END = '''      mbar_arrive(empty + 8 * st);   // this thread is done with step t
    }
'''
_DKV_OVERLAP = '''    auto step_q0 = [&](int t) {
      const int gi = t / per_head;
      return (i0 + t - gi * per_head) * kTile;
    };
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
    if (wg == 1) turn_pass(wg);
    {
      float s[kTile / 2], dp[kTile / 2];
      mbar_wait(full, 0);
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, k_wg, ring);
      issue_abt<D>(dp, v_wg, ring + kQBytes);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      dkv_p_ds(s, dp, step_q0(0), key, kw, col2, S, p.causal, scale_log2,
               vec_p);
      to_a_fragments(s, pa);
      to_a_fragments(dp, dsa);
    }
    for (int t = 1; t < n_steps; ++t) {
      const int st = t % kDkvStages, pst = (t - 1) % kDkvStages;
      const uint32_t qs = ring + st * kStage, pqs = ring + pst * kStage;
      float s[kTile / 2], dp[kTile / 2];
      mbar_wait(full + 8 * st, (t / kDkvStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, k_wg, qs);
      issue_abt<D>(dp, v_wg, qs + kQBytes);
      wgmma_commit();
      issue_ab<D>(dv, pa, pqs + kQBytes);
      issue_ab<D>(dk, dsa, pqs);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      hold(s);
      hold(dp);
      dkv_p_ds(s, dp, step_q0(t), key, kw, col2, S, p.causal, scale_log2,
               vec_p + st * 2 * kTile);
      wgmma_wait<0>();
      hold(dk);
      hold(dv);
      mbar_arrive(empty + 8 * pst);
      to_a_fragments(s, pa);
      to_a_fragments(dp, dsa);
    }
    {
      const uint32_t qs = ring + ((n_steps - 1) % kDkvStages) * kStage;
      turn_wait(wg);
      wgmma_fence();
      issue_ab<D>(dv, pa, qs + kQBytes);
      issue_ab<D>(dk, dsa, qs);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      hold(dk);
      hold(dv);
    }
'''

# P and dS formed apart, so the exp can run while dP is in flight.
_SPLIT_HELPERS = '''
__device__ __forceinline__ void dkv_p(float (&s)[kTile / 2], int q0,
                                      int key, int kw, int col2, int S,
                                      int causal, float scale_log2,
                                      const float* lv) {
  if (q0 + kTile > S || (causal && q0 < kw + 63)) {
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int q = q0 + (i >> 2) * 8 + col2 + (i & 1);
      const int kr = key + ((i >> 1) & 1) * 8;
      if (q >= S || (causal && kr > q)) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int c = 0; c < kTile / 8; ++c) {
    const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * c + col2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * c + e] = exp2_approx(
          fmaf(s[4 * c + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
  }
}
__device__ __forceinline__ void dkv_ds(const float (&s)[kTile / 2],
                                       float (&dp)[kTile / 2], int col2,
                                       const float* lv) {
#pragma unroll
  for (int c = 0; c < kTile / 8; ++c) {
    const float2 dd =
        *reinterpret_cast<const float2*>(lv + kTile + 8 * c + col2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * c + e] =
          s[4 * c + e] * (dp[4 * c + e] - ((e & 1) ? dd.y : dd.x));
  }
}
__device__ __forceinline__ void dq_p(float (&s)[kTile / 2], int k0, int row,
                                     int col2, int r0, int S, int causal,
                                     float scale_log2,
                                     const float (&lse2)[2]) {
  if (k0 + kTile > S || (causal && k0 + kTile - 1 > r0)) {
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int key = k0 + (i >> 2) * 8 + col2 + (i & 1);
      const int qrow = row + ((i >> 1) & 1) * 8;
      if (key >= S || (causal && key > qrow)) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i)
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
}
__device__ __forceinline__ void dq_ds(float (&s)[kTile / 2],
                                      const float (&dp)[kTile / 2],
                                      const float (&dsum)[2]) {
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i)
    s[i] = s[i] * (dp[i] - dsum[(i >> 1) & 1]);
}

'''
_DQ_ANCHOR = ('// -------------------------------------------------------------'
              '----- dq\n')
_DKV_JOINT = '''      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, k_wg, qs);     // Sᵀ = K Qᵀ
      issue_abt<D>(dp, v_wg, dos);   // dPᵀ = V dOᵀ
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      hold(s);
      hold(dp);

      dkv_p_ds(s, dp, q0, key, kw, col2, S, p.causal, scale_log2,
               vec_p + st * 2 * kTile);
      uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
      to_a_fragments(s, pa);
      to_a_fragments(dp, dsa);

      turn_wait(wg);
      wgmma_fence();
      issue_ab<D>(dv, pa, dos);      // dV += Pᵀ dO
      issue_ab<D>(dk, dsa, qs);      // dK += dSᵀ Q
      wgmma_commit();
'''
_DKV_SPLIT = '''      const float* const lv = vec_p + st * 2 * kTile;
      turn_wait(wg);
      wgmma_fence();
      issue_abt<D>(s, k_wg, qs);
      wgmma_commit();
      issue_abt<D>(dp, v_wg, dos);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      hold(s);
      dkv_p(s, q0, key, kw, col2, S, p.causal, scale_log2, lv);
      uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
      to_a_fragments(s, pa);
      turn_wait(wg);
      wgmma_fence();
      issue_ab<D>(dv, pa, dos);
      wgmma_commit();
      wgmma_wait<1>();
      hold(dp);
      dkv_ds(s, dp, col2, lv);
      to_a_fragments(dp, dsa);
      wgmma_fence();
      issue_ab<D>(dk, dsa, qs);
      wgmma_commit();
'''
_DQ_JOINT = '''      issue_abt<D>(s, q_wg, ks);
      issue_abt<D>(dp, do_wg, ks + kKBytes);
      wgmma_commit();
      issue_ab<D>(dq, dsa, ring + pst * kStage);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();
      hold(s);
      hold(dp);
      dq_ds_tile(s, dp, j * kTile, row, col2, r0, S, p.causal, scale_log2,
                 lse2, dsum);
'''
_DQ_SPLIT = '''      issue_abt<D>(s, q_wg, ks);
      wgmma_commit();
      issue_abt<D>(dp, do_wg, ks + kKBytes);
      wgmma_commit();
      issue_ab<D>(dq, dsa, ring + pst * kStage);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<2>();
      hold(s);
      dq_p(s, j * kTile, row, col2, r0, S, p.causal, scale_log2, lse2);
      wgmma_wait<1>();
      hold(dp);
      dq_ds(s, dp, dsum);
'''


def variants(src):
    """name → source text."""
    start = src.index(_DKV_LOOP_START)
    end = src.index(_DKV_LOOP_END) + len(_DKV_LOOP_END)
    overlap = _edit(src[:start] + _DKV_OVERLAP + src[end:],
                    ('constexpr int kDkvStages = 2;',
                     'constexpr int kDkvStages = 3;'),
                    ('setmaxnreg_dec<40>();', 'setmaxnreg_dec<24>();'),
                    ('setmaxnreg_inc<232>();', 'setmaxnreg_inc<240>();'))
    split = _edit(src, (_DQ_ANCHOR, _DQ_ANCHOR + _SPLIT_HELPERS),
                  (_DKV_JOINT, _DKV_SPLIT), (_DQ_JOINT, _DQ_SPLIT))
    return {'committed': src,
            'dq_two_stages': _edit(src, ('constexpr int kDqStages = 3;',
                                         'constexpr int kDqStages = 2;')),
            'dkv_overlap': overlap,
            'split_issue': split}


def _nvcc(sources):
    """Compile {name: (text, extra flags)} together → {name: (path, log)}."""
    DEV_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, extra) in sources.items():
        cu = DEV_DIR / f'{name}.cu'
        cu.write_text(text)
        so = DEV_DIR / f'lib{name}.so'
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *extra, '-I',
             str(cuda_build.CSRC_DIR), '-o', str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    built = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode(errors='replace')
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log[-4000:]}')
        built[name] = (so, log)
    return built


def _sass(so):
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), 'cuobjdump')
    out = subprocess.run([tool, '-sass', str(so)], capture_output=True,
                         text=True, check=True).stdout
    return [re.sub(r'/\*[0-9a-f]+\*/|;.*', '', line).strip()
            for line in out.splitlines() if re.match(r'\s+/\*[0-9a-f]+\*/',
                                                     line)]


def _launchers(so):
    lib = ctypes.CDLL(str(so))
    sizes = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fns = {}
    for which, symbol, n_ptrs in (('dq', 'skytorch_flash_bwd_dq_wgmma', 7),
                                  ('dkv', 'skytorch_flash_bwd_dkv_wgmma', 8)):
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + sizes
        fns[which] = fn
    return fns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--forward-parent', default=None,
                        help='an older flash_forward_wgmma.cu to compare '
                        'SASS with')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    print(chip_smoke.smi_line(), flush=True)
    cuda_build.build()
    src = (cuda_build.CSRC_DIR / 'flash_backward_wgmma.cu').read_text()
    sources = {name: (text, ()) for name, text in variants(src).items()}
    if args.forward_parent:
        fwd = cuda_build.CSRC_DIR / 'flash_forward_wgmma.cu'
        sources['forward_parent'] = (open(args.forward_parent).read(), ())
        sources['forward_committed'] = (fwd.read_text(), ())
    built = _nvcc(sources)
    if args.forward_parent:
        same = (_sass(built['forward_parent'][0]) ==
                _sass(built['forward_committed'][0]))
        print(f'forward SASS {"identical to" if same else "DIFFERS from"} '
              f'the parent\'s', flush=True)
    launchers = {}
    for name in variants(src):
        so, log = built[name]
        spills = sorted(set(re.findall(r'(\d+) bytes spill stores', log)))
        regs = sorted(set(re.findall(r'Used (\d+) registers', log)))
        print(f'{name}: registers at launch {regs}, spill stores (bytes) '
              f'{spills}', flush=True)
        launchers[name] = _launchers(so)

    b, s, h, hkv, d, causal = SHAPES
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                (b, s, h, d)))
    out, lse = fa.flash_forward_kernel(q, k, v, causal)
    dsum = fa.row_dot(g, out)
    ref = (fa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum, causal),
           *fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal))
    bounds = chip_smoke.flash_bounds(b, s, h, hkv, d, causal, 2,
                                     chip_smoke.PEAK_BF16_FLOPS)
    stream = torch.cuda.current_stream().cuda_stream
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    calls = {}
    for name, fns in launchers.items():
        for which, fn in fns.items():
            tensors = ((q, k, v, g, lse, dsum, outs[0]) if which == 'dq' else
                       (q, k, v, g, lse, dsum, outs[1], outs[2]))
            ptrs = [t.data_ptr() for t in tensors]

            def call(fn=fn, ptrs=ptrs):
                err = fn(*ptrs, 1, b, s, h, hkv, d, int(causal), d**-0.5,
                         stream)
                if err:
                    raise SystemExit(f'launch failed (code {err})')
            calls[name, which] = call
    times = {key: [] for key in calls}
    for rnd in range(3):
        for (name, which), call in calls.items():
            times[name, which].append(chip_smoke.cuda_time_ms(call))
            if rnd:
                continue
            torch.cuda.synchronize()
            pick = (0,) if which == 'dq' else (1, 2)
            if all(torch.equal(outs[i], ref[i]) for i in pick):
                continue
            want = fa.flash_backward_plain(q, k, v, out, lse, g, causal)
            for i in pick:
                err, msg = chip_smoke.twin_error(outs[i], want[i], 'bf16')
                print(f'{name} {("dq", "dk", "dv")[i]}: not the committed '
                      f'bits; twin {"ok" if err is None else err}: {msg}',
                      flush=True)
            del want
    for (name, which), ms in times.items():
        bound_ms, _, flops = bounds[f'flash_bwd_{which}_kernel']
        best = min(ms)
        print(f'{name:15s} {which:3s} ms ' + ' '.join(f'{x:.4f}' for x in ms)
              + f' ({flops / best / 1e9:.1f} TFLOP/s, {bound_ms / best:.3f} '
              f'of the bound)', flush=True)

    def einsum():
        return torch.einsum('bshd,bshd->bhs', g.float(),
                            out.float()).contiguous()

    diff = (fa.row_dot(g, out) - einsum()).abs().max().item()
    row_ms = chip_smoke.cuda_time_ms(lambda: fa.row_dot(g, out))
    print(f'row_dot ms {row_ms:.4f}, einsum over two fp32 copies ms '
          f'{chip_smoke.cuda_time_ms(einsum):.4f} (max |diff| {diff:.3e})',
          flush=True)
    pair = chip_smoke.cuda_time_ms(lambda: (
        fa.flash_bwd_dq_kernel(q, k, v, g, lse, fa.row_dot(g, out), causal),
        fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal)))
    sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal,
                                              enable_gqa=True)
    sdpa_bwd = chip_smoke.cuda_time_ms(lambda: torch.autograd.grad(
        sdpa_out, (sq, sk, sv), g.transpose(1, 2), retain_graph=True))
    print(f'pair (row_dot, dq, dk/dv) ms {pair:.4f}; SDPA backward ms '
          f'{sdpa_bwd:.4f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
