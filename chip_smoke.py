#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, printing no result, when CUDA is unavailable or the
port's package is not beside it. Phases (any failure exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``); build every
   CUDA kernel from ``skypilot_tpu_torch/csrc`` (one nvcc per source,
   started together) and print the build seconds and ptxas report; the
   bf16 flash forward's and backward's kernels must hold HGMMA (wgmma)
   instructions in their SASS (``cuobjdump -sass``), and the decode
   library's tensor-core kernels (bf16 q: dense decode, paged decode,
   verify at hd 128 over bf16 and int8 K/V among them) HMMA (mma.sync)
   instructions.
2. Kernels against their plain PyTorch versions at the serving path's
   shapes (B=8, H=32, Hkv=8, hd=128, max_len 2048, block_k 128, ragged
   lengths 0/1/127/128/129/2048/...): dense bf16 and int8, paged bf16
   and int8 through shuffled tables with two rows sharing blocks. Prints
   each max abs error against its tolerance, the kernel's time, the
   plain version's time, ``library_ms`` (``scaled_dot_product_attention``
   over expanded K/V, a yardstick the port never calls), the bytes
   bound and the kernel's fraction of it. The kernel's ms (the
   launcher's split and combine kernels) and SDPA's are the card's time
   for calls queued behind a spin kernel (``device_ms``), since events
   around back-to-back calls of a kernel this short time the host; the
   event time of a call is printed beside it.
3. Main path: llama3-8b at full width and depth with random weights from
   a seed, served by the port's ``ModelServer`` on a local port — dense
   bf16, dense int8-KV and paged replicas in turn — answering streamed
   and unary ``/generate`` requests (prompts of ~16 to ~1000 tokens, 32
   new tokens; the paged replica gets two requests sharing a 256-token
   prefix). Checks token counts, that each kernel's launch count grew
   by exactly n_layers x decode steps, and that the paged replica reused
   the prefix; prints decode tokens/s with the card's name.
4. Kernel path against plain path end to end: the same teacher-forced
   tokens through the dense and paged decode steps under 'kernel' and
   'plain', in fp32 and in bf16; logits within a stated tolerance,
   greedy tokens equal wherever the plain path's top-1/top-2 gap
   exceeds it.
5. Where a decode step's time goes: the 8-slot dense and paged bf16
   steps timed on the host clock (kernel and plain paths in turns), then
   torch.profiler's device time by kernel over the kernel path, decode
   attention's split kernel and its combine apart; fails unless the
   profiled decode attention ran the tensor-core kernels.
6. Flash-attention kernels (forward, dq, dk/dv; in bf16 the wgmma
   kernels of ``csrc/flash_forward_wgmma.cu`` and
   ``csrc/flash_backward_wgmma.cu``, in fp32 the CUDA-core bodies of
   ``csrc/flash_attention.cu``) against their plain
   twins at the training shapes (B=12, S=2048, H=16, Hkv=8, D=128,
   causal) in bf16 and fp32, at an S that does not tile (1000) and a
   small non-causal case (fp32 within 2e-5 of the twin's largest value;
   bf16 per element within one ulp plus 2e-2 of its row's rms, and
   within 5e-3 in relative norm); at the training shapes each kernel's time,
   achieved TFLOP/s and fraction of its bound, the plain twin's,
   ``library_ms`` (``scaled_dot_product_attention``
   with ``enable_gqa`` and its autograd backward, a yardstick the port
   never calls) and the bound with what sets it; then the backward pair
   as the trainer calls it (``row_dot``, dq, dk/dv) against SDPA's
   backward, like for like.
7. Main path of the trainer: bench-1b at full width and depth (flash
   attention, remat 'full', ce_chunks 8, batch 12 x seq 2048, warmup
   10) through ``train.make_train_step`` for 8 steps on one fixed
   batch. Checks finite, falling losses and that every step launches
   the forward kernel 2 x n_layers times and each backward kernel
   n_layers times; prints tokens/s, MFU against 989 TFLOP/s, peak
   memory and one step's device time by kernel (torch.profiler), with
   the card's name and power limit. Then ``train.train_loop`` with a
   checkpoint directory, cut after step 2 and resumed: the resumed
   step-3 loss must equal the unbroken run's.
8. Kernel path against plain path on the training loss: bench-1b at
   batch 2, one set of bf16 params (and the same upcast to fp32) and one
   batch through the flash kernels and their twins. fp32: loss, grad
   norm and every grad tensor within stated tolerances. bf16: loss and
   grad norm likewise, and each grad tensor no further from the fp32
   plain path than 1.2 times the plain bf16 path is.
9. Speculative decoding (kernel 3), run after phase 5 while the
   llama3-8b weights are loaded. (a) The paged-verify kernel against its
   twin under phase 6's ``twin_error`` rule at the serving shapes (B 8,
   H 32, Hkv 8, hd 128, block_k 128, shuffled tables with two rows
   sharing blocks), S 1/5/9, bf16 and int8 K/V, starts 0 to max_len-2
   (so 2046 + S runs past the table); at every S query i must be
   bit-identical to the paged decode kernel at cur_len = start + i + 1.
   Prints ms, the twin's ms, ``library_ms`` (SDPA over the gathered,
   expanded K/V with an explicit [S, T] mask), the bytes bound and the
   kernel's fraction of it. (b) The main path: paged llama3-8b replicas
   of the port's
   ModelServer with spec_k 4 at drafter depth 1 and 32 (bf16) and depth
   1 with int8 K/V, answering phase 3's paged requests: token counts,
   verify launches exactly n_layers x rounds, no decode-kernel launch,
   prefix reuse; tokens/s, tokens per lane per round and the accept
   ratio. (c) Parity: bf16 spec tokens against phase 3's paged replica,
   a divergence allowed only where the plain path's top-1/top-2 gap is
   at most 8 bf16 ulps of its top logit (each printed with its gap in
   ulps, that request compared no further); fp32 at full width and 8
   layers, drafter depth 1 and 8, exactly equal to the non-spec paged
   engine. Then one round's host time and device time split (drafter;
   verify step: verify kernel, its combine, GEMMs, the rest) under
   torch.profiler; fails unless the verify step ran the tensor-core
   verify kernel.
10. Chunked prefill and supervision, run after phase 9 while the
   llama3-8b weights are loaded, through the port's ModelServer on a
   local port; the launch counts are reset just before and read just
   after. (a) A paged bf16 replica with ``prefill_chunk`` 256 answers
   phase 3's paged requests: paged-decode launches exactly n_layers x
   decode steps, no dense-decode or verify launch, the chunked
   admissions and chunks ``radix_chunks`` predicts (ceil((p - m) / 256)
   for each prompt whose uncached suffix exceeds 256), prefix reuse,
   and tokens against phase 3's unchunked replica under phase 9's
   divergence rule; at full width and 8 layers in fp32, chunked tokens
   exactly equal to unchunked. (b) The same with spec_k 4 at drafter
   depth 1: verify launches exactly n_layers x rounds, no decode-kernel
   launch, the same chunk and token checks. (c) Head-of-line, printed
   and not gated: 7 lanes decoding 64 tokens when a 1,920-token prompt
   arrives, with chunk 256 and then 0: the lanes' largest inter-token
   gap while it prefills, its TTFT and its chunks, on the host clock.
   (d) ``SKYTPU_CHAOS=engine_step_raise:1`` armed while 8 lanes decode
   and one request is queued, on a paged and a dense replica: the 8
   in-flight requests get their error within 10 s, ``restarts`` reads
   1, the queued request gives phase 3's tokens for its prompt, device
   memory allocated after the restart is at most 64 MiB above the
   memory before the crash, the decode kernel ran n_layers x decode
   steps across the restart; then with ``SKYTPU_ENGINE_MAX_RESTARTS=0``
   one more crash fails the engine for good (/healthz 503, /generate
   503 with ``Retry-After: 30``). (e) ``POST /drain`` with 4 requests in
   flight: 202, all 4 finish their 64 tokens, /generate answers 503
   with ``Retry-After``, /healthz 503, and the server stops by itself.
11. Serving telemetry, run after phase 10 while the llama3-8b weights are
   loaded, through the port's ModelServer on a local port; each replica
   gets a fresh metrics registry and its own journal file
   (``SKYTPU_JOURNAL_PATH`` in a temporary directory); the launch counts
   are reset just before and read just after. (a) A paged bf16 replica
   answers phase 3's paged requests, each with its own ``X-Request-Id``
   (answered back); ``GET /metrics``: ``skytpu_engine_steps_total`` x
   n_layers equals the paged-decode launches, ``tokens_total`` the
   tokens the clients got, ``admitted_total``, ``evicted_total`` and
   ``ttft_seconds_count`` the request count, ``compiles_total`` the
   distinct ``engine.compile`` rows of the journal. (b)
   ``skytpu_engine_hbm_bytes`` weights and paged_pool (kv_cache on a
   dense replica) equal their tensors' bytes, workspace >= 0 and
   measured, and the ``engine.hbm`` row says the same. (c) ``/slo`` has
   the reference server's keys and counts every request; its TTFT and
   per-token p50/p95/p99 printed; ``/debug/requests`` lists every
   request under its trace id; ``/debug/engine``'s step ring is not
   empty; ``/journal`` answers 404, and with ``SKYTPU_JOURNAL_PEERS``
   one request's ``server.request`` span with its ``engine.admit`` and
   ``engine.evict`` rows under it. (d) The same on a spec replica
   (spec_k 4, drafter depth 1: verify launches = n_layers x rounds) and
   the drafted/accepted counters and accept-ratio gauge against
   ``/slo``'s ``spec`` block; and on a dense replica (the dense decode
   kernel, the kv_cache split). (e) Printed, not gated: the median
   engine tick of an 8 x 64-token burst with the journal on and with
   ``SKYTPU_JOURNAL_DISABLED=1`` in turns (host clock), then with
   ``journal_write_stall`` armed at 2 s a flush, the burst's largest
   inter-token gap and the ``journal.stall`` row after recovery.

12. Int8 weights and checkpoint restore, run after phase 11 while the
   llama3-8b weights are loaded; the launch counts are reset just
   before and read just after. (a) The int8 route (``ops/quant``: row
   quantisation, cuBLASLt's int8 GEMM through ``torch._int_mm``,
   rescale) bit-equal to its twin (the same over an exact fp64 product)
   at M 8/40/1000 x llama3-8b's four (K, N); the GEMM's device time,
   its bound, the same GEMM over a row-major weight, the whole int8
   matmul and bf16 ``x @ w``. (b) ``build_engine(int8=True)`` dense,
   paged and spec (spec_k 4, drafter depth 1) replicas answer phase 3's
   requests: token counts, each attention kernel's launches n_layers x
   steps, the int8 GEMM's launches exactly 7 per layer pass, the
   weights' bytes in the HBM split against the config (9,086,705,664);
   then phase 5's profile of the int8 step beside the bf16 one. (c)
   Kernel vs plain decode attention with int8 weights, teacher-forced,
   dense and paged: within INT8_E2E_REL_TOL on the first
   INT8_E2E_LAYERS layers (twin_error's statistics printed), where a
   planted kernel reading the wrong KV head must break the bound; the
   full depth's reading printed. (d) The seed-0 bf16 params saved with
   ``checkpoint.save_params`` (17 GB free needed under ``build/``); a
   replica built the CLI's way (``checkpoint_dir``, ``int8=True``, no
   params, seed 1) logs the restored step and gives (b)'s dense tokens,
   the same build without ``checkpoint_dir`` gives others, and a
   trainer checkpoint raises ValueError.

13. The cross-replica prefix fetch, run after phase 12 while the
   llama3-8b weights are loaded; the launch counts are reset just
   before and read just after. For bf16 and then int8 K/V, paged
   replicas of the port's ModelServer on local ports (8 slots, max_len
   2048, block_k 128), built with ``prefix_peers``: an owner answers a
   prompt of a 1,024-token prefix (8 blocks) and a 24-token tail; a
   fetcher, whose peers are the owner and itself (its own URL must be
   left out) and whose budget is 60 s (``SKYTPU_PREFIX_FETCH_BUDGET_
   SECONDS``), answers four prompts of that prefix with tails of 16-40
   tokens, 32 new tokens each, the first alone (it fetches), the other
   three together (radix hits). (a) Every prompt's tokens equal those
   of a control without peers that first prefilled the owner's prompt
   itself, so that its first prompt takes the fetcher's path (the
   prefix from the radix cache, the tail prefilled over it); a cold
   control would prefill 1,040 tokens in one pass, whose bf16 logits
   differ in their last bits. (b) ``/slo``'s cache block counts one
   fetch hit of 1,024 tokens and no miss, and ``/journal`` (open on a
   replica with peers) holds the ``hit`` row from the owner's URL. (c)
   The fetcher's 8 blocks equal the owner's (``torch.equal``) in every
   layer, K, V and the scale planes. (d) The paged-decode kernel ran
   exactly n_layers x the decode steps of every replica of the phase,
   the dense and verify kernels never. Printed, not gated: the fetch's
   seconds from its journal row against the first-token time of the
   owner's prompt prefilled locally and of the same prompt cold, the
   payload's bytes (JSON and raw) and a client's read of it, and the
   outcome of one more fetcher left at the default 0.5 s budget, whose
   tokens are held to the control its outcome implies (the one above on
   a hit, the cold one otherwise).

14. The trainers, run after phase 8; the flash launch counts are reset
   just before and read just after. (a) bench-1b as phase 7 builds it,
   once per remat policy ('full', 'dots', 'ffn', 'ffn1', 'attn'), each
   from the seed-0 state, 3 steps on one fixed batch: the flash kernels
   launch exactly [2L, L, L] a step under every policy (the reference
   recomputes the flash forward under all five), every step's loss and
   grad norm and the params after the last step equal 'full''s bit for
   bit, and ``max_memory_allocated`` rises
   full < attn < ffn1 < ffn < dots; each policy's step seconds,
   tokens/s, MFU and peak GB are printed, with its peak over 'full''s
   beside the bytes the reference's residual set predicts. (b)
   ``train.train_loop`` for 4 steps with ``SKYTPU_PROFILE_DIR`` a
   temporary directory and ``SKYTPU_PROFILE_STEPS=2``: a fresh registry
   counts 4 steps, its MFU gauge equals ``tokens_per_second_to_mfu`` of
   its tokens/s gauge at the card's peak from
   ``utils/accelerator_registry`` (and is > 0), the gauge agrees with
   the loop's own last step time within 1%, and one capture is
   written, whose trace names the flash forward kernel. (c) ResNet-50 at
   224 x 224, bf16, batch 128, 10 momentum-SGD steps on one fixed batch
   at learning rate 1e-3: finite, falling losses; examples/s and peak
   memory printed; then the debug ResNet in fp32 on the card against the
   port on the CPU (TF32 off), held to ``tests/test_torch_resnet.py``'s
   tolerances.

15. The disaggregated prefill/decode handoff, run after phase 13 while
   the llama3-8b weights are loaded; the launch counts are reset just
   before and read just after. For bf16 and then int8 K/V, three paged
   replicas of the port's ModelServer on local ports (8 slots, max_len
   2048, block_k 128, prefill_chunk 256, one set of params): a prefill
   replica (role ``prefill``, whose peer is the decode replica), a
   decode replica (role ``decode``, whose peer is the prefill replica)
   and a monolithic control (``mixed``). The prompts have 1,000 tokens:
   7 full blocks and a 104-token tail, 4 chunks, so the prefill replica
   pushes 2, 2, 2 and 1 blocks and the push of a chunk overlaps the next
   chunk's prefill. (a) ``POST /prefill_handoff`` naming the decode
   replica in ``X-Skytpu-Handoff-Target``, under a 60 s push budget
   (``SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS``), answers ``complete``; the
   prefill replica ran no decode step; ``/slo``'s handoff blocks count
   896 tokens pushed and 896 injected; then ``/generate`` of the same
   prompt on the decode replica saves at least 896 prompt tokens, gives
   the control's tokens (its second answer of the prompt, which takes
   the same path: 7 blocks from its radix cache, the tail prefilled
   over them), and its 7 blocks equal the control's (``torch.equal``,
   every plane). (b) The paged-decode kernel launched exactly n_layers x
   the decode replica's steps during that ``/generate``, and over the
   phase n_layers x every replica's steps; the dense and verify kernels
   never. (c) An untrusted target, and ``SKYTPU_CHAOS=
   handoff_decode_death`` on the decode side, answer ``degraded`` with
   all 32 tokens, and the dead peer is in the prefill replica's backoff.
   (d) Once, in bf16, the default 2 s budget: its outcome (``complete``
   or ``degraded``) printed, the request answered in full either way.
   Printed: the prefill leg's wall time, each push's blocks, raw bytes
   and seconds, and the decode replica's first-token time against the
   control's, cold and over its own cache.

Every replica journals into a temporary directory of the run, not into
``~/.skytpu``. Before phase 13 the whole run took 273.7 s on an H100
(700 W), phase 12 88.9 s of it (its int8 step profile 36.9 s, the 16 GB
save and restore 31.3 s), well inside its time limit, so every phase
runs at full depth; phase 14 adds ~45 s (~70 s alone with the build),
and ``PERF.md`` has the whole run's time with phases 13 and 14.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""
import atexit
import gc
import glob
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is max(bytes / HBM rate, operations / peak rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

B, H, HKV, HD, MAX_LEN, BLOCK_K = 8, 32, 8, 128, 2048, 128
CUR_LENS = [0, 1, 127, 128, 129, 2048, 1000, 513]
# Kernel vs plain, same inputs. bf16: the plain path rounds the
# probabilities (and dequantised int8 K/V) to bf16 before the PV
# product, the kernel keeps fp32 until the final cast, so outputs may
# differ by a few bf16 ulps of values of magnitude <= ~4.
KERNEL_ATOL = {'bf16': 3e-2, 'int8': 3e-2}
# End to end (llama3-8b, random init), relative to the largest logit.
# fp32: kernel and plain differ only in summation order. bf16: the one-
# ulp attention differences (probabilities rounded to bf16 in the plain
# path only) grow through 32 layers of bf16 rounding; 0.058 was measured
# on an H100 (700 W) before this bound was set.
E2E_REL_TOL = {'fp32': 1e-3, 'bf16': 1e-1}
# Phase 9, bf16 spec vs non-spec tokens: at a divergence the plain
# path's top-1/top-2 gap may be at most this many bf16 ulps of its top
# logit (ulp = 2^(floor(log2|top|) - 7)); the gaps read on an H100
# (700 W) at logits near 5 were 1-4 ulps before this bound was set.
SPEC_PARITY_BF16_ULPS = 8

MODEL = 'llama3-8b'
N_NEW = 32
# Phase 9: speculative decoding on the paged replica (kernel 3).
SPEC_K = 4
VERIFY_S = (1, SPEC_K + 1, 2 * SPEC_K + 1)
VERIFY_STARTS = [0, 126, 127, 128, 1000, MAX_LEN - 2, 513, 1500]
VERIFY_SOURCE = 'skypilot_tpu/ops/decode_attention.py:467 _paged_verify_kernel'
# The fp32 parity check runs llama3-8b's width at this depth.
SPEC_PARITY_LAYERS = 8
# Phase 10: chunked prefill and supervision on the paged replica.
PREFILL_CHUNK = 256
# (c) head-of-line: lanes decoding HOL_NEW tokens when a long prompt
# arrives.
HOL_LANES, HOL_NEW, HOL_PROMPT = 7, 64, 1920
# (d) an injected crash must fail the in-flight requests within this
# (the request timeout is minutes), and the rebuilt cache may leave at
# most this much more memory allocated than before the crash (the old
# pool is 2.16 GB at 8 slots x 16 blocks + 1).
FAIL_FAST_SECONDS = 10.0
RESTART_MEM_SLACK = 64 * 2**20

DECODE_SOURCES = {
    'decode_attention_kernel': 'skypilot_tpu/ops/decode_attention.py:80',
    'paged_decode_attention_kernel':
        'skypilot_tpu/ops/decode_attention.py:273'}
FLASH_SOURCES = {
    'flash_forward_kernel': 'skypilot_tpu/ops/flash_attention.py:37',
    'flash_bwd_dq_kernel': 'skypilot_tpu/ops/flash_attention.py:145',
    'flash_bwd_dkv_kernel': 'skypilot_tpu/ops/flash_attention.py:191'}
# The port's source of each bf16 kernel (the wgmma kernels; fp32 stays
# in flash_attention.cu).
FLASH_FILES = {
    'flash_forward_kernel': 'skypilot_tpu_torch/csrc/flash_forward_wgmma.cu',
    'flash_bwd_dq_kernel': 'skypilot_tpu_torch/csrc/flash_backward_wgmma.cu',
    'flash_bwd_dkv_kernel':
        'skypilot_tpu_torch/csrc/flash_backward_wgmma.cu'}
# The libraries whose every kernel must be wgmma (HGMMA in its SASS).
WGMMA_LIBRARIES = ('flash_forward_wgmma', 'flash_backward_wgmma')
# H100 SXM non-tensor fp32 peak (data sheet): the fp32 flash kernels run
# on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
# Phase 6 cases, (B, S, H, Hkv, D, causal): the training shapes, an S
# that does not tile, a small non-causal case.
FLASH_CASES = {'train': (12, 2048, 16, 8, 128, True),
               'S=1000': (2, 1000, 16, 8, 128, True),
               'full': (2, 256, 4, 2, 64, False)}
# Kernel vs twin. fp32, relative to the twin's largest |value|: only the
# summation order differs. bf16: the kernels round P and dS to bf16
# before the second product, the twins keep fp32, and both round the
# result to bf16. So every element must hold |got - want| <= rtol·|want|
# + atol·row_scale(want) (rtol: one bf16 ulp at the top of a binade;
# atol: the P/dS rounding carried through a row's sum, ~1e-3 of that
# row's rms, which does not shrink with an element that cancels to ~0),
# and the whole tensor ||got - want|| <= fro·||want||. Set at about
# twice the largest values read on an H100 (700 W) with the bounds
# opened, at the phase-6 and cuda-test shapes; phase 6 prints both
# statistics on every run.
FLASH_FP32_REL_TOL = 2e-5
FLASH_BF16_TOL = dict(rtol=2.0**-7, atol=2e-2, fro=5e-3)
# Phases 7-8: bench-1b as bench.py trains it.
TRAIN_MODEL = 'bench-1b'
TRAIN_B, TRAIN_S, TRAIN_STEPS = 12, 2048, 8
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke_ckpt')
# A resumed step against the unbroken run: same params, moments and
# batch, so only run-to-run nondeterminism may differ.
RESUME_REL_TOL = 1e-6
# Phase 8, kernel path vs plain path on the bench-1b loss (batch 2),
# relative: loss, global grad norm, and in fp32 the worst per-tensor
# ||dg|| / ||g||. In bf16 each grad tensor's distance from the fp32
# plain path may be at most TRAIN_BF16_GRAD_RATIO times the plain bf16
# path's. Set from a reading on an H100 (700 W) with the bounds opened
# (phase 8 prints every one of these numbers on every run).
TRAIN_E2E_TOL = {'fp32': dict(loss=1e-5, grad_norm=1e-4, grad=1e-4),
                 'bf16': dict(loss=1e-4, grad_norm=1e-3)}
TRAIN_BF16_GRAD_RATIO = 1.2
# Phase 14 (a): steps per remat policy, each from the seed-0 state on
# one fixed batch; peak memory must rise in this order (the bytes each
# policy keeps: the block input, then attn_out, w1's, w1's and w3's,
# and the six GEMM outputs of 'dots').
POLICY_STEPS = 3
REMAT_MEMORY_ORDER = ('full', 'attn', 'ffn1', 'ffn', 'dots')
# (b) train_loop steps with a profile capture of 2 of them.
PROFILED_STEPS = 4
# (c) ResNet-50 at ImageNet's 224 x 224, bf16. The reference's default
# learning rate (0.1, no warm-up) diverges on one fixed batch in both
# packages (a CPU run at batch 8 passed 1e18 by step 10), so the fixed-
# batch check trains at 1e-3; the step's work is the same.
RESNET_MODEL, RESNET_B, RESNET_SIZE = 'resnet50', 128, 224
RESNET_STEPS, RESNET_LR = 10, 1e-3
# The debug ResNet in fp32, card against CPU (TF32 off): only the
# summation order differs, so tests/test_torch_resnet.py's rules, each
# relative to the largest |value| of the CPU result.
RESNET_PARITY_TOL = dict(logits=2e-5, loss=2e-5, grads=2e-4,
                         step_loss=2e-5, params=2e-4)
# Main-path and end-to-end phases run here (a rehearsal may point them
# at the CPU and a small model; the kernel phase always needs the card).
DEVICE = 'cuda'


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def sass_counts(cuda_build, lib_name, opcode):
    """{kernel (mangled name): instructions of ``opcode``} in the built
    library's SASS (cuobjdump, beside nvcc)."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), 'cuobjdump')
    lib = cuda_build.library_path(lib_name)
    sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def wgmma_sass_check(cuda_build) -> None:
    """The bf16 flash forward's and backward's products must be wgmma:
    every kernel in each of their built libraries holds HGMMA
    instructions."""
    for lib in WGMMA_LIBRARIES:
        counts = sass_counts(cuda_build, lib, 'HGMMA')
        print(f'[build] HGMMA instructions per kernel of '
              f'{cuda_build.library_path(lib).name}: {counts}', flush=True)
        if not counts or not all(counts.values()):
            fail(f'{lib} has a kernel without HGMMA')


# The tensor-core instantiations the serving path runs (bf16 q, hd 128):
# dense decode, paged decode and verify over bf16 and int8 (mangled
# 'a') K/V, as mangled-name fragments.
DECODE_MMA_KERNELS = [f'{kernel}I{kv}Li128E{flag}'
                      for kv in ('13__nv_bfloat16', 'a')
                      for kernel, flag in (
                          ('decode_attention_mma_kernel', 'Lb0E'),
                          ('decode_attention_mma_kernel', 'Lb1E'),
                          ('paged_verify_mma_kernel', 'EEv'))]


def hmma_sass_check(cuda_build) -> None:
    """The decode library's bf16 bodies must run on mma.sync: every
    ``*_mma_kernel`` holds HMMA instructions, and the dense decode, paged
    decode and verify kernels at hd 128 over bf16 and int8 K/V exist."""
    counts = sass_counts(cuda_build, 'decode_attention', 'HMMA')
    mma = {fn: n for fn, n in counts.items() if 'mma_kernel' in fn}
    short = {fn[min(fn.find(k) for k in ('decode_attention_mma',
                                          'paged_verify_mma') if k in fn):]:
             n for fn, n in mma.items()}
    print(f'[build] HMMA instructions per tensor-core kernel of '
          f'{cuda_build.library_path("decode_attention").name}: {short}',
          flush=True)
    missing = [want for want in DECODE_MMA_KERNELS
               if not any(want in fn and n for fn, n in mma.items())]
    if missing or not all(mma.values()):
        fail(f'a bf16 decode/verify kernel has no HMMA: missing {missing}, '
             f'counts {short}')


def smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(torch) -> None:
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.synchronize()


def empty_cache(torch) -> None:
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.empty_cache()


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A spin of this many SM clock cycles (~25 ms at the H100's 1.98 GHz)
# holds the stream while device_ms enqueues its calls.
SPIN_CYCLES = 50_000_000


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call on the card alone. The decode kernels run for
    tens of µs, less than the wrapper's host work, so events around
    back-to-back calls (``cuda_time_ms``) time the host. Here a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the ``iters`` calls, so the events around them see the
    card run them back to back. Fails if the host was still enqueueing
    when the spin ended."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_start, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin_start.elapsed_time(start)
    if not enqueue_ms < spin_ms:
        fail(f'device_ms: enqueueing took {enqueue_ms:.2f} ms, longer than '
             f'the {spin_ms:.2f} ms spin that holds the stream')
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 2


def kernel_phase(torch, da, quant):
    """Kernel vs plain at the serving shapes; returns per-kernel rows."""
    import torch.nn.functional as F
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    q = torch.randn(B, 1, H, HD, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, MAX_LEN, HKV, HD, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, MAX_LEN, HKV, HD, generator=gen, device=dev).bfloat16()
    cur = torch.tensor(CUR_LENS, dtype=torch.int32, device=dev)
    kq, ks = quant.quantize_kv(k)
    vq, vs = quant.quantize_kv(v)

    # Paged pool: every row's blocks at shuffled pool positions; row 7
    # names row 6's blocks (a shared prefix), so both read one copy.
    nb = MAX_LEN // BLOCK_K
    n_pool = B * nb + 1          # the engine's default pool: + scratch 0
    perm = torch.randperm(B * nb, generator=gen, device=dev) + 1
    tables = perm.reshape(B, nb).to(torch.int32)
    tables[7] = tables[6]

    def to_pool(dense):
        pool = torch.zeros((n_pool, BLOCK_K) + dense.shape[2:],
                           dtype=dense.dtype, device=dev)
        pool[tables[:7].long()] = dense[:7].reshape(
            (7, nb, BLOCK_K) + dense.shape[2:])
        return pool

    pools = {'bf16': (to_pool(k), to_pool(v), None, None),
             'int8': (to_pool(kq), to_pool(vq), to_pool(ks), to_pool(vs))}
    dense = {'bf16': (k, v, None, None), 'int8': (kq, vq, ks, vs)}

    def bound(kind, paged):
        # Bytes this data needs: each live K/V row once. Paged row 7
        # reads a prefix of row 6's blocks, which are read once.
        live = sum(CUR_LENS[:7] if paged else CUR_LENS)
        elem = 1 if kind == 'int8' else 2
        kv_bytes = live * HKV * HD * 2 * elem
        if kind == 'int8':
            kv_bytes += live * HKV * 2 * 4
        other = 2 * B * H * HD * 2 + B * 4
        if paged:
            other += sum(-(-c // BLOCK_K) for c in CUR_LENS) * 4
        flops = 4 * live * H * HD
        t_bytes = (kv_bytes + other) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                     else 'operations')

    def sdpa_inputs(kk, vv, kss, vss, tbl):
        if tbl is not None:
            kk, vv, kss, vss = da.gather_paged_kv(kk, vv, tbl, kss, vss)
        if kss is not None:
            kk = (kk.float() * kss[..., None]).bfloat16()
            vv = (vv.float() * vss[..., None]).bfloat16()
        g = H // HKV
        t = kk.shape[1]

        def expand(x):   # [B,T,Hkv,hd] → [B,H,T,hd], head kv*G + r
            return x[:, :, :, None].expand(B, t, HKV, g, HD).reshape(
                B, t, H, HD).transpose(1, 2).contiguous()

        mask = (torch.arange(t, device=dev)[None, :] <
                cur[:, None].long())[:, None, None, :]
        return q.transpose(1, 2).contiguous(), expand(kk), expand(vv), mask

    rows = {}
    for name, kernel_fn, plain_fn, is_paged in (
            ('decode_attention_kernel', da.decode_attention_kernel,
             da.decode_attention_plain, False),
            ('paged_decode_attention_kernel',
             da.paged_decode_attention_kernel,
             da.paged_decode_attention_plain, True)):
        row = {}
        for kind in ('bf16', 'int8'):
            if is_paged:
                kk, vv, kss, vss = pools[kind]
                args = (q, kk, vv, tables, cur, kss, vss)
            else:
                kk, vv, kss, vss = dense[kind]
                args = (q, kk, vv, cur, kss, vss)
            out = kernel_fn(*args)
            torch.cuda.synchronize()
            ref = plain_fn(*args)
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f'{name} {kind}: bad output')
            if out[0].abs().max().item() != 0.0:
                fail(f'{name} {kind}: cur_len == 0 row is not zero')
            err = (out.float() - ref.float()).abs().max().item()
            tol = KERNEL_ATOL[kind]
            print(f'[kernels] {name} {kind}: max_abs_err={err:.3e} '
                  f'(tol {tol})', flush=True)
            if not err <= tol:
                fail(f'{name} {kind}: max abs err {err} > {tol}')
            ms = device_ms(lambda: kernel_fn(*args))
            call_ms = cuda_time_ms(lambda: kernel_fn(*args))
            plain_ms = cuda_time_ms(lambda: plain_fn(*args), iters=5)
            sq, sk, sv, mask = sdpa_inputs(kk, vv, kss, vss,
                                           tables if is_paged else None)
            library_ms = device_ms(
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask))
            bound_ms, bound_by = bound(kind, is_paged)
            print(f'[kernels] {name} {kind}: ms={ms:.4f} (device; '
                  f'{call_ms:.4f} a call back to back, host included) '
                  f'plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} '
                  f'bound_ms={bound_ms:.4f} ({bound_by}; the kernel at '
                  f'{bound_ms / ms:.4f} of it)', flush=True)
            row[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, call_ms=call_ms)
        rows[name] = row
    return rows


# --------------------------------------------------------------- phase 3


def post(port: int, body: dict, timeout: float = 600.0, headers=None):
    """POST /generate; the reply's tokens, with the answered X-Request-Id
    under ``request_id``."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read().decode()
        rid = resp.headers.get('X-Request-Id')
        if not body.get('stream', True):
            return {**json.loads(raw), 'request_id': rid}
    events = [json.loads(line[len('data: '):])
              for line in raw.splitlines() if line.startswith('data: ')]
    if not events or not events[-1].get('done'):
        fail(f'stream ended without a done event: {events[-1:]}')
    if 'error' in events[-1]:
        fail(f'stream error: {events[-1]}')
    return {'tokens': [e['token'] for e in events],
            'generated': events[-1]['generated'],
            'finish_reason': events[-1]['finish_reason'], 'request_id': rid}


def serve_phase(torch, ms_lib, params, label, engine_kwargs, requests,
                kernel_fn, card, idle_fns=()):
    """One replica: start the port's server, answer ``requests`` (lists
    of (body) batches sent concurrently), check counts: ``kernel_fn``
    launched n_layers times per decode step (a speculative round is one
    step), each of ``idle_fns`` never. Returns (stats, [(body, reply)]);
    the stats add the engine's build seconds (``build_s``) and its
    weights' bytes in the HBM split (``weights_bytes``)."""
    t_build = time.perf_counter()
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params,
                                 **engine_kwargs)
    sync(torch)
    build_s = time.perf_counter() - t_build
    server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    before = kernel_fn.launches
    idle_before = [fn.launches for fn in idle_fns]
    results = []
    t0 = time.perf_counter()
    try:
        for batch in requests:
            out = [None] * len(batch)
            errors = []

            def run(i, body):
                try:
                    out[i] = post(port, body)
                except BaseException as e:  # noqa: BLE001 re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i, b))
                       for i, b in enumerate(batch)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            if errors:
                raise errors[0]
            results += list(zip(batch, out))
        sync(torch)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                    timeout=60) as resp:
            if json.loads(resp.read())['admitted'] != len(results):
                fail(f'{label}: /stats does not count every request')
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/healthz',
                                    timeout=60) as resp:
            if resp.status != 200:
                fail(f'{label}: /healthz {resp.status}')
    finally:
        server.stop()
    stats = engine.stats()   # the engine thread has stopped
    stats['build_s'] = build_s
    stats['weights_bytes'] = engine._hbm_accounting()[  # pylint: disable=protected-access
        'per_device_bytes']['weights']
    for body, res in results:
        n = body['max_new_tokens']
        if res is None or len(res['tokens']) != n or res['generated'] != n:
            fail(f'{label}: expected {n} tokens, got {res}')
        if res['finish_reason'] != 'length':
            fail(f'{label}: finish_reason {res["finish_reason"]}')
        if not all(0 <= t < ms_lib.llama.CONFIGS[MODEL].vocab_size
                   for t in res['tokens']):
            fail(f'{label}: token out of range')
    launches = kernel_fn.launches - before
    n_layers = ms_lib.llama.CONFIGS[MODEL].n_layers
    expect = n_layers * stats['decode_steps']
    if stats['decode_steps'] == 0 or launches != expect:
        fail(f'{label}: {kernel_fn.__name__} launched {launches} times, '
             f'expected n_layers x decode steps = {expect}')
    for fn, n in zip(idle_fns, idle_before):
        if fn.launches != n:
            fail(f'{label}: {fn.__name__} launched {fn.launches - n} times, '
                 'expected none')
    tok_s = stats['decode_tokens'] / wall
    print(f'[serve] {label}: {len(results)} requests, decode_steps='
          f'{stats["decode_steps"]} decode_tokens={stats["decode_tokens"]} '
          f'{kernel_fn.__name__} launches={launches} wall={wall:.2f}s '
          f'decode tokens/s={tok_s:.1f} on {card}', flush=True)
    return stats, results


def main_path_phase(torch, ms_lib, da, card):
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = ms_lib.llama.init_params(cfg, gen, DEVICE)
    sync(torch)
    print(f'[serve] {MODEL} params ({cfg.num_params() / 1e9:.2f}B, '
          f'random init seed 0) in {time.perf_counter() - t0:.1f}s',
          flush=True)
    rng = random.Random(0)

    def prompt(n):
        return [rng.randrange(cfg.vocab_size) for _ in range(n)]

    def body(tokens, stream):
        return {'prompt': tokens, 'max_new_tokens': N_NEW,
                'stream': stream}

    lens = [16, 200, 1000, 77, 512, 333]
    dense_batch = [body(prompt(n), i % 2 == 0) for i, n in enumerate(lens)]
    shared = prompt(256)
    paged_batches = [[body(shared + prompt(40), True)],
                     [body(shared + prompt(90), False)] +
                     [body(prompt(n), i % 2 == 1)
                      for i, n in enumerate(lens[:4])]]
    decode_kernels = (da.decode_attention_kernel,
                      da.paged_decode_attention_kernel)
    da.reset_launch_counts()
    _, dense_results = serve_phase(torch, ms_lib, params, 'dense bf16', {},
                                   [dense_batch], da.decode_attention_kernel,
                                   card)
    serve_phase(torch, ms_lib, params, 'dense int8-KV', {'kv_int8': True},
                [dense_batch], da.decode_attention_kernel, card)
    paged, paged_results = serve_phase(torch, ms_lib, params, 'paged bf16',
                                       {'paged': True}, paged_batches,
                                       da.paged_decode_attention_kernel,
                                       card)
    counts = {fn.__name__: fn.launches for fn in decode_kernels}
    for name, n in counts.items():
        if n == 0:
            fail(f'{name} was never launched on the main path')
    if paged['prefill_tokens_saved'] <= 0:
        fail(f'paged replica reused no prefix: {paged}')
    print(f'[serve] paged prefix hit tokens={paged["prefill_tokens_saved"]}'
          f' blocks_used={paged["blocks_used"]}', flush=True)
    return params, counts, paged_batches, paged_results, dense_results


# --------------------------------------------------------------- phase 4


def forced_case(torch, cfg):
    """Teacher-forcing inputs for the end-to-end phases: 4 prompts of
    300 tokens at lengths 300/129/17/256, 4 forced steps, max_len 512,
    each row's blocks at reversed pool positions."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    b, s, steps, max_len = 4, 300, 4, 512
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    nbk = max_len // BLOCK_K
    return dict(
        b=b, steps=steps, max_len=max_len, nbk=nbk, prompt=prompt,
        lens=torch.tensor([300, 129, 17, 256], device=dev),
        forced=torch.randint(0, cfg.vocab_size, (steps, b), generator=gen,
                             device=dev),
        tables=(torch.arange(b * nbk, device=dev) + 1).flip(0).reshape(
            b, nbk).to(torch.int32),
        padded=torch.nn.functional.pad(
            prompt, (0, -(-s // BLOCK_K) * BLOCK_K - s)))


def teacher_forced(torch, decode, p, cfg, case, paged, impl):
    """Logits [steps, b, vocab] of the forced tokens after a prefill,
    through the dense or paged decode step under ``impl``."""
    dev = torch.device(DEVICE)
    b, max_len, tables = case['b'], case['max_len'], case['tables']
    lens, padded = case['lens'], case['padded']
    dcfg = decode.DecodeConfig(max_len=max_len, decode_attention=impl)
    if paged:
        cache = decode.init_block_pool(cfg, b * case['nbk'] + 1, BLOCK_K,
                                       device=dev)
        for i in range(b):
            decode.paged_prefill(p, padded[i:i + 1], int(lens[i]),
                                 tables[i, :padded.shape[1] // BLOCK_K],
                                 cfg, cache)
    else:
        cache = decode.init_kv_cache(cfg, b, max_len, device=dev)
        decode.prefill(p, case['prompt'], cfg, cache, lens)
    outs = []
    pos = lens.clone()
    for t in range(case['steps']):
        token = case['forced'][t]
        if paged:
            outs.append(decode.paged_decode_step(p, token, pos, tables, cfg,
                                                 dcfg, cache))
        else:
            outs.append(decode.decode_step(p, token, pos, cfg, dcfg, cache))
        pos = pos + 1
    return torch.stack(outs)


def e2e_check(torch, kl, pl, rel_tol, label):
    """Kernel-path logits ``kl`` against plain-path ``pl``: max |dlogit|
    within rel_tol x max |logit|, greedy tokens equal wherever the plain
    path's top-1/top-2 gap exceeds that. Returns max |dlogit| /
    max |logit|."""
    if not (torch.isfinite(kl).all() and kl.shape == pl.shape):
        fail(f'end-to-end {label}: kernel logits not finite / wrong shape')
    scale = pl.abs().max().item()
    diff = (kl - pl).abs().max().item()
    tol = rel_tol * scale
    top2 = pl.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    agree = kl.argmax(-1) == pl.argmax(-1)
    print(f'[e2e] {label}: max|dlogit|={diff:.4e} (tol {tol:.4e} = '
          f'{rel_tol} x max|logit| {scale:.3f}); greedy equal on '
          f'{int(agree[clear].sum())}/{int(clear.sum())} clear-gap '
          f'positions, {int(agree.sum())}/{agree.numel()} overall',
          flush=True)
    if diff > tol:
        fail(f'end-to-end {label} logits differ by {diff} > {tol}')
    if not agree[clear].all():
        fail(f'end-to-end {label} greedy tokens differ at a clear gap')
    return diff / scale


def e2e_phase(torch, decode, llama, params):
    """Teacher-forced decode steps, kernel vs plain, dense and paged, in
    fp32 (the kernel and the plain path differ only in summation order)
    and in bf16 (the serving dtype). Returns the worst relative diff per
    dtype."""
    import dataclasses
    cfg16 = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    case = forced_case(torch, cfg16)

    worst = {}
    for dtype_name, rel_tol in (('fp32', E2E_REL_TOL['fp32']),
                                ('bf16', E2E_REL_TOL['bf16'])):
        if dtype_name == 'fp32':
            cfg = dataclasses.replace(cfg16, dtype=torch.float32)
            p = {'layers': {k: w.float() for k, w in
                            params['layers'].items()},
                 **{k: w.float() for k, w in params.items()
                    if k != 'layers'}}
        else:
            cfg, p = cfg16, params
        for paged in (False, True):
            kl = teacher_forced(torch, decode, p, cfg, case, paged, 'kernel')
            pl = teacher_forced(torch, decode, p, cfg, case, paged, 'plain')
            rel = e2e_check(torch, kl, pl, rel_tol,
                            f'{dtype_name} {"paged" if paged else "dense"}')
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), rel)
        del p
        sync(torch)
        torch.cuda.empty_cache() if dev.type == 'cuda' else None
    return worst


# --------------------------------------------------------------- phase 5


PROFILE_LENS = [16, 200, 1000, 77, 512, 333, 700, 900]


def profile_phase(torch, decode, llama, params, card, weights='bf16'):
    """Where one decode step's time goes: the 8-slot dense and paged
    steps (``weights``: 'bf16', or 'int8' for quantised params) at
    ragged live lengths (PROFILE_LENS), host clock around synchronised
    steps for 'kernel' and 'plain', then torch.profiler over the kernel
    path for device time by kernel name. Returns {'dense'|'paged':
    {host_ms, wall_ms, busy_ms, gemm_ms, launches}} per step."""
    from torch.profiler import ProfilerActivity, profile
    cfg = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    b = len(PROFILE_LENS)
    pos0 = torch.tensor(PROFILE_LENS, device=dev)
    token = torch.zeros(b, dtype=torch.long, device=dev)
    nbk = MAX_LEN // BLOCK_K
    tables = (torch.arange(b * nbk, device=dev) + 1).reshape(b, nbk).to(
        torch.int32)
    out = {}
    for paged in (False, True):
        if paged:
            cache = decode.init_block_pool(cfg, b * nbk + 1, BLOCK_K,
                                           device=dev)
        else:
            cache = decode.init_kv_cache(cfg, b, MAX_LEN, device=dev)
        label = f'{"paged" if paged else "dense"} {weights}'

        def step(dcfg):
            # The same positions every step: K/V values do not change
            # what the step costs.
            if paged:
                decode.paged_decode_step(params, token, pos0, tables, cfg,
                                         dcfg, cache)
            else:
                decode.decode_step(params, token, pos0, cfg, dcfg, cache)

        # Per-step host clock, each step synchronised (the engine syncs
        # once per step too); impls in turns: kernel, plain, plain,
        # kernel, 20 steps each after 3 warm-up steps.
        samples = {'kernel': [], 'plain': []}
        for impl in ('kernel', 'plain', 'plain', 'kernel'):
            dcfg = decode.DecodeConfig(max_len=MAX_LEN, decode_attention=impl)
            for _ in range(3):
                step(dcfg)
            sync(torch)
            for _ in range(20):
                t0 = time.perf_counter()
                step(dcfg)
                sync(torch)
                samples[impl].append((time.perf_counter() - t0) * 1e3)
        stats = {impl: (statistics.median(v),
                        statistics.quantiles(v, n=10)[-1])
                 for impl, v in samples.items()}
        print(f'[profile] {label} decode step, 8 slots, live lengths '
              f'{PROFILE_LENS}, host clock (median / p90 of 40): kernel '
              f'path {stats["kernel"][0]:.3f} / {stats["kernel"][1]:.3f} '
              f'ms, plain path {stats["plain"][0]:.3f} / '
              f'{stats["plain"][1]:.3f} ms, on {card}', flush=True)
        dcfg = decode.DecodeConfig(max_len=MAX_LEN)
        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step(dcfg)
            sync(torch)
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_time_by_kernel(torch, prof)
        busy_ms = sum(r[0] for r in rows)
        if busy_ms == 0:
            print(f'[profile] {label}: the profiler recorded no device '
                  'time', flush=True)
            continue
        attn_names = {r[1] for r in rows if 'decode_attention' in r[1]}
        if not attn_names or not all('mma_kernel' in n for n in attn_names):
            fail(f'{label}: the decode step did not run the tensor-core '
                 f'decode kernel: {sorted(attn_names)}')
        attn_ms = sum(r[0] for r in rows if 'decode_attention' in r[1])
        combine_ms = sum(r[0] for r in rows if 'combine_partials' in r[1])
        gemm_ms = sum(r[0] for r in rows
                      if 'nvjet' in r[1] or 'gemm' in r[1].lower())
        launches = sum(r[2] for r in rows)
        print(f'[profile] {label}: {n_prof} steps under torch.profiler: '
              f'wall {wall_ms / n_prof:.3f} ms/step, device busy '
              f'{busy_ms / n_prof:.3f} ms/step ({busy_ms / wall_ms:.3f} of '
              f'wall), {launches / n_prof:.0f} kernels/step; decode '
              f'attention {attn_ms / n_prof:.3f} ms/step '
              f'({attn_ms / busy_ms:.3f} of device time) and its combine '
              f'{combine_ms / n_prof:.3f} ms/step, GEMMs '
              f'{gemm_ms / n_prof:.3f} ms/step ({gemm_ms / busy_ms:.3f})',
              flush=True)
        for ms, key, count in rows[:6 if weights == 'bf16' else 12]:
            print(f'[profile] {label}:   {ms / n_prof:8.3f} ms/step  '
                  f'x{count // n_prof:<4d} {key[:80]}', flush=True)
        out[label.split()[0]] = dict(
            host_ms=stats['kernel'][0], wall_ms=wall_ms / n_prof,
            busy_ms=busy_ms / n_prof, gemm_ms=gemm_ms / n_prof,
            launches=launches / n_prof)
        del cache
    return out


# --------------------------------------------------------------- phase 9


def verify_bound(tables, starts, s, kind):
    """Least time of one verify call: max(bytes / HBM rate, operations /
    peak bf16 rate). Bytes: every (pool block, offset) that some query
    attends, read once (row 7 reads a prefix of row 6's blocks, counted
    once), K and V (+ fp32 scales when int8), q and out, the live table
    entries and the starts. Operations: 4 flops per (query head, key
    position, dim) that each query attends (QK and PV)."""
    import numpy as np
    cap = tables.shape[1] * BLOCK_K
    live = [min(st + s, cap) for st in starts]
    cells = np.unique(np.concatenate([
        tables[b, np.arange(n) // BLOCK_K] * BLOCK_K +
        np.arange(n) % BLOCK_K for b, n in enumerate(live)]))
    elem = 1 if kind == 'int8' else 2
    nbytes = cells.size * HKV * HD * 2 * elem
    if kind == 'int8':
        nbytes += cells.size * HKV * 2 * 4
    nbytes += 2 * len(starts) * s * H * HD * 2 + len(starts) * 4
    nbytes += sum(-(-n // BLOCK_K) for n in live) * 4
    flops = sum(4 * min(st + i + 1, cap) * H * HD
                for st in starts for i in range(s))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def verify_kernel_phase(torch, da, quant):
    """Kernel 3 against its twin at the serving shapes (B 8, H 32, Hkv 8,
    hd 128, block_k 128, 16 blocks a row through shuffled tables, rows 6
    and 7 sharing blocks), S in VERIFY_S, bf16 and int8 K/V, starts
    VERIFY_STARTS (2046 + S runs past max_len). Checks twin_error, that
    S = 1 is bit-identical to the paged decode kernel at cur_len =
    start + 1, and reports how far query i is from the decode kernel at
    cur_len = start + i + 1. Times the kernel, the twin and SDPA over the
    gathered, expanded K/V with an explicit [S, T] mask. Returns the rows
    at S = SPEC_K + 1 for the kernels line."""
    import torch.nn.functional as F
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    nb = MAX_LEN // BLOCK_K
    n_pool = B * nb + 1
    tables = (torch.randperm(B * nb, generator=gen, device=dev) + 1).reshape(
        B, nb).to(torch.int32)
    tables[7] = tables[6]
    k, v = (torch.randn(n_pool, BLOCK_K, HKV, HD, generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    pools = {'bf16': (k, v, None, None), 'int8': (kq, vq, ks, vs)}
    start = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    tables_np = tables.cpu().numpy()
    g = H // HKV
    rows = {}
    for s in VERIFY_S:
        q = torch.randn(B, s, H, HD, generator=gen, device=dev).bfloat16()
        for kind in ('bf16', 'int8'):
            kk, vv, kss, vss = pools[kind]
            args = (q, kk, vv, tables, start, kss, vss)
            out = da.paged_verify_attention_kernel(*args)
            torch.cuda.synchronize()
            want = da.paged_verify_attention_plain(*args)
            if out.shape != want.shape or not torch.isfinite(out).all():
                fail(f'paged verify S={s} {kind}: bad output')
            err, msg = twin_error(out, want, 'bf16')
            label = f'paged_verify_attention_kernel S={s} {kind}'
            print(f'[verify] {label}: {msg}', flush=True)
            if err is not None:
                fail(f'{label}: {err}')
            dec = [da.paged_decode_attention_kernel(
                q[:, i:i + 1].contiguous(), kk, vv, tables, start + i + 1,
                kss, vss) for i in range(s)]
            torch.cuda.synchronize()
            same = all(torch.equal(out[:, i:i + 1], d)
                       for i, d in enumerate(dec))
            diff = max((out[:, i:i + 1].float() - d.float()).abs().max()
                       .item() for i, d in enumerate(dec))
            print(f'[verify] {label}: query i vs the paged decode kernel '
                  f'at start + i + 1: '
                  f'{"bitwise equal" if same else f"max diff {diff:.3e}"}',
                  flush=True)
            if not same:
                fail(f'{label}: a query is not bit-identical to the paged '
                     'decode kernel')
            ms = device_ms(lambda: da.paged_verify_attention_kernel(*args))
            call_ms = cuda_time_ms(
                lambda: da.paged_verify_attention_kernel(*args))
            plain_ms = cuda_time_ms(
                lambda: da.paged_verify_attention_plain(*args), iters=5)
            gk, gv, gks, gvs = da.gather_paged_kv(kk, vv, tables, kss, vss)
            if gks is not None:
                gk = (gk.float() * gks[..., None]).bfloat16()
                gv = (gv.float() * gvs[..., None]).bfloat16()
            t = gk.shape[1]

            def expand(x):   # [B,T,Hkv,hd] → [B,H,T,hd], head kv*G + r
                return x[:, :, :, None].expand(B, t, HKV, g, HD).reshape(
                    B, t, H, HD).transpose(1, 2).contiguous()

            sk, sv = expand(gk), expand(gv)
            sq = q.transpose(1, 2).contiguous()
            mask = (torch.arange(t, device=dev)[None, None, :] <=
                    (start[:, None, None] + torch.arange(s, device=dev)
                     [None, :, None]))[:, None]          # [B, 1, S, T]
            library_ms = device_ms(
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask))
            del gk, gv, sk, sv, sq, mask
            bound_ms, bound_by = verify_bound(tables_np, VERIFY_STARTS, s,
                                              kind)
            print(f'[verify] {label}: ms={ms:.4f} (device; {call_ms:.4f} a '
                  f'call back to back, host included) plain_ms='
                  f'{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms='
                  f'{bound_ms:.4f} ({bound_by}; the kernel at '
                  f'{bound_ms / ms:.4f} of it)', flush=True)
            if s == SPEC_K + 1:
                rows[kind] = dict(
                    max_abs_err=(out.float() - want.float()).abs().max()
                    .item(), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                    call_ms=call_ms, decode_max_diff=diff)
            del out, want, dec
    del pools, k, v, kq, vq, ks, vs
    torch.cuda.empty_cache()
    return rows


def spec_serve_phase(torch, ms_lib, da, params, paged_batches, card):
    """The main path of kernel 3: paged llama3-8b replicas of the port's
    ModelServer with spec_k SPEC_K, drafter depth 1 and full depth
    (bf16) and depth 1 with int8 K/V, answering phase 3's paged
    requests. Launch counts are reset just before and read just after.
    Returns (counts, {label: (stats, results)})."""
    n_layers = ms_lib.llama.CONFIGS[MODEL].n_layers
    replicas = [('spec bf16 drafter 1', dict(drafter_layers=1)),
                (f'spec bf16 drafter {n_layers}',
                 dict(drafter_layers=n_layers)),
                ('spec int8-KV drafter 1', dict(drafter_layers=1,
                                                kv_int8=True))]
    runs = {}
    da.reset_launch_counts()
    for label, kwargs in replicas:
        stats, results = serve_phase(
            torch, ms_lib, params, label,
            dict(paged=True, spec_k=SPEC_K, **kwargs), paged_batches,
            da.paged_verify_attention_kernel, card,
            idle_fns=(da.decode_attention_kernel,
                      da.paged_decode_attention_kernel))
        if stats['prefill_tokens_saved'] <= 0:
            fail(f'{label}: no prefix reuse: {stats}')
        lane_rounds = stats['spec_drafted'] // SPEC_K
        print(f'[spec] {label}: {stats["decode_steps"]} rounds, '
              f'{stats["decode_tokens"]} tokens, '
              f'{stats["decode_tokens"] / lane_rounds:.3f} tokens per lane '
              f'per round, accept ratio {stats["spec_accept_ratio"]}, '
              f'prefix hit tokens {stats["prefill_tokens_saved"]}; on {card}',
              flush=True)
        runs[label] = (stats, results)
    counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    if counts['paged_verify_attention_kernel'] == 0:
        fail('paged_verify_attention_kernel was never launched on the '
             'speculative path')
    return counts, runs


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x|: 2^(floor(log2|x|) - 7)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0**-133


def first_divergences(torch, llama, params, cfg, pairs, max_ulps, label):
    """Greedy tokens of a speculative run against the non-speculative
    run, request by request, compared up to the first difference. At a
    difference, the top-1/top-2 gap of the plain path's logits there (a
    full forward over the prompt and the non-speculative tokens before
    it) must be at most max_ulps bf16 ulps of its top logit (a near-tie);
    None demands equality. Returns [(request, position, gap, gap in
    ulps)]."""
    found = []
    for n, (prompt, want, got) in enumerate(pairs):
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if j is None and len(want) == len(got):
            continue
        if j is None:
            fail(f'{label}: request {n} lengths {len(want)} vs {len(got)}')
        seq = torch.tensor([prompt + want[:j]], device=DEVICE)
        with torch.no_grad():
            x = llama.forward_hidden(params, seq, cfg)[0, -1]
            logits = (x @ params['lm_head']).float()
        top2 = logits.topk(2).values
        gap = (top2[0] - top2[1]).item()
        ulp = bf16_ulp(top2[0].item())
        tol = 0.0 if max_ulps is None else max_ulps * ulp
        print(f'[spec-parity] {label}: request {n} diverges at token {j} '
              f'({want[j]} vs {got[j]}); plain-path top-1/top-2 gap '
              f'{gap:.4e} = {gap / ulp:.2f} bf16 ulps of the top logit '
              f'{top2[0].item():.4f}, tol {tol:.4e} ({max_ulps} ulps); not '
              'compared further', flush=True)
        found.append((n, j, gap, gap / ulp))
        if not gap <= tol:
            fail(f'{label}: request {n} differs at token {j} with a clear '
                 f'gap {gap} > {tol}')
    return found


def fp32_cut(torch, params, cfg16):
    """llama3-8b's width at SPEC_PARITY_LAYERS layers in fp32: (config,
    params cut from the bf16 ones)."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg16, n_layers=SPEC_PARITY_LAYERS,
                                dtype=torch.float32)
    p32 = {'layers': {k: w[:SPEC_PARITY_LAYERS].float()
                      for k, w in params['layers'].items()},
           **{k: w.float() for k, w in params.items() if k != 'layers'}}
    return cfg32, p32


def drain_engine(ms_lib, eng, prompts):
    """Submit N_NEW-token requests for ``prompts`` all at once and step
    the engine until every one finished; returns their tokens."""
    reqs = [ms_lib.engine_lib.Request(p, N_NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        if steps > 10 * N_NEW:
            fail(f'{eng.name} engine did not finish')
    return [r.tokens for r in reqs]


def spec_parity_phase(torch, ms_lib, decode, llama, params, paged_results,
                      spec_runs):
    """Speculative tokens against the non-speculative paged path on the
    same prompts and params: (1) bf16 at full depth, each bf16 spec
    replica of spec_serve_phase against phase 3's paged replica, a
    divergence allowed only at a near-tie of at most
    SPEC_PARITY_BF16_ULPS bf16 ulps of the top logit; (2) fp32 at full
    width and SPEC_PARITY_LAYERS layers, spec engines (drafter depth 1
    and full depth) against a non-spec paged engine, exactly equal."""
    cfg16 = llama.CONFIGS[MODEL]
    base = [(body['prompt'], res['tokens']) for body, res in paged_results]
    for label, (_, results) in spec_runs.items():
        if 'bf16' not in label:
            continue
        pairs = [(p, want, res['tokens'])
                 for (p, want), (_, res) in zip(base, results)]
        div = first_divergences(torch, llama, params, cfg16, pairs,
                                SPEC_PARITY_BF16_ULPS, label)
        print(f'[spec-parity] {label} vs paged bf16: '
              f'{len(pairs) - len(div)}/{len(pairs)} requests token-'
              f'identical, {len(div)} near-tie divergences', flush=True)
    cfg32, p32 = fp32_cut(torch, params, cfg16)
    # Drafter depth 1 rejects nearly every draft (the rollback path);
    # full depth accepts most (the multi-token accept path).
    tokens = {}
    for spec_k, depth in ((0, 1), (SPEC_K, 1), (SPEC_K, SPEC_PARITY_LAYERS)):
        dcfg = decode.DecodeConfig(max_len=MAX_LEN, spec_k=spec_k,
                                   spec_drafter_layers=depth)
        eng = ms_lib.engine_lib.DecodeEngine(p32, cfg32, dcfg, 8,
                                             step_chunk=4, paged=True)
        tokens[spec_k, depth] = drain_engine(ms_lib, eng,
                                             [p for p, _ in base])
        st = eng.stats()
        del eng
        if not spec_k:
            continue
        label = f'fp32 {SPEC_PARITY_LAYERS} layers drafter {depth}'
        pairs = [(p, want, got) for (p, _), want, got in
                 zip(base, tokens[0, 1], tokens[spec_k, depth])]
        first_divergences(torch, llama, p32, cfg32, pairs, None, label)
        print(f'[spec-parity] {label}: {st["decode_steps"]} rounds, accept '
              f'ratio {st["spec_accept_ratio"]}; spec tokens equal the '
              f'non-spec paged tokens in all {len(pairs)} requests',
              flush=True)
    del p32
    empty_cache(torch)


def spec_profile_phase(torch, decode, llama, params, card):
    """Where one speculative round goes (8 lanes at PROFILE_LENS, bf16,
    spec_k SPEC_K, drafter depth 1): the round on the host clock, then
    torch.profiler device time of the drafter and of the verify step,
    each over its own window, split into the verify kernel, GEMMs and
    the rest."""
    from torch.profiler import ProfilerActivity, profile
    cfg = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    b = len(PROFILE_LENS)
    pos = torch.tensor(PROFILE_LENS, device=dev)
    token = torch.zeros(b, dtype=torch.long, device=dev)
    nbk = MAX_LEN // BLOCK_K
    tables = (torch.arange(b * nbk, device=dev) + 1).reshape(b, nbk).to(
        torch.int32)
    npb = -(-max(PROFILE_LENS) // BLOCK_K)
    draft_tables = tables[:, :1 << (npb - 1).bit_length()]
    pool = decode.init_block_pool(cfg, b * nbk + 1, BLOCK_K, device=dev)
    dcfg = decode.DecodeConfig(max_len=MAX_LEN, spec_k=SPEC_K,
                               spec_drafter_layers=1)

    def draft():
        return decode.spec_draft_tokens(params, token, pos, draft_tables,
                                        cfg, dcfg, pool)

    seq = torch.cat([token[:, None], draft()], dim=1)

    def verify():
        return decode.paged_verify_step(params, seq, pos, tables, cfg, dcfg,
                                        pool)

    for _ in range(3):
        verify()
    samples = []
    for _ in range(10):
        sync(torch)
        t0 = time.perf_counter()
        torch.cat([token[:, None], draft()], dim=1)
        verify().argmax(-1).cpu()
        samples.append((time.perf_counter() - t0) * 1e3)
    print(f'[spec-profile] one round (drafter depth 1, spec_k {SPEC_K}, '
          f'8 lanes at {PROFILE_LENS}), host clock median '
          f'{statistics.median(samples):.3f} ms of 10, on {card}',
          flush=True)
    n_prof = 3
    split = {}
    for name, fn in (('drafter', draft), ('verify', verify)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync(torch)
            for _ in range(n_prof):
                fn()
            sync(torch)
        rows = device_time_by_kernel(torch, prof)
        busy = sum(r[0] for r in rows) / n_prof
        gemm = sum(r[0] for r in rows if any(
            key in r[1].lower() for key in ('gemm', 'nvjet', 'cutlass',
                                            'xmma'))) / n_prof
        verify_names = {r[1] for r in rows if 'paged_verify' in r[1]}
        if busy and name == 'verify' and not (
                verify_names and all('mma_kernel' in n
                                     for n in verify_names)):
            fail(f'the bf16 verify step did not run the tensor-core verify '
                 f'kernel: {sorted(verify_names)}')
        attn = sum(r[0] for r in rows if 'paged_verify' in r[1]) / n_prof
        combine = sum(r[0] for r in rows
                      if 'combine_partials' in r[1]) / n_prof
        split[name] = dict(busy_ms=busy, gemm_ms=gemm, verify_attn_ms=attn,
                           combine_ms=combine,
                           kernels=sum(r[2] for r in rows) // n_prof)
        print(f'[spec-profile] {name}: device busy {busy:.3f} ms, GEMMs '
              f'{gemm:.3f} ms, verify attention {attn:.3f} ms and its '
              f'combine {combine:.3f} ms, other '
              f'{busy - gemm - attn - combine:.3f} ms, '
              f'{split[name]["kernels"]} kernels', flush=True)
        for ms, key, count in rows[:5]:
            print(f'[spec-profile] {name}:   {ms / n_prof:8.3f} ms  '
                  f'x{count // n_prof:<4d} {key[:80]}', flush=True)
    del pool
    empty_cache(torch)
    return split


# -------------------------------------------------------------- phase 10


def radix_chunks(batches, block_k, chunk):
    """(chunked admissions, prefill chunks) a paged replica with
    ``prefill_chunk`` = ``chunk`` counts for ``batches`` sent one after
    another. A prompt's cached prefix m is its longest run of whole
    blocks published by an earlier batch, capped at p - 1 (the prompts
    of one batch share no block here, so their order inside the batch
    does not matter); it is chunked when p - m > chunk, in
    ceil((p - m) / chunk) chunks."""
    published = set()
    admissions = chunks = 0
    for batch in batches:
        for body in batch:
            prompt = body['prompt']
            p, m = len(prompt), 0
            while (m + block_k <= p and
                   tuple(prompt[:m + block_k]) in published):
                m += block_k
            m = min(m, p - 1)
            if p - m > chunk:
                admissions += 1
                chunks += -(-(p - m) // chunk)
        for body in batch:
            prompt = body['prompt']
            published.update(tuple(prompt[:j * block_k])
                             for j in range(1, len(prompt) // block_k + 1))
    return admissions, chunks


def chunked_phase(torch, ms_lib, da, decode, llama, params, paged_batches,
                  paged_results, card):
    """(a) A paged bf16 replica with prefill_chunk PREFILL_CHUNK and (b)
    the same with spec_k SPEC_K at drafter depth 1 answer phase 3's paged
    requests: exact launch counts (serve_phase), the chunk counts
    radix_chunks predicts, prefix reuse, and tokens against phase 3's
    unchunked replica under phase 9's divergence rule. Then fp32 at
    full width and SPEC_PARITY_LAYERS layers: chunked tokens exactly
    equal to unchunked."""
    cfg16 = llama.CONFIGS[MODEL]
    want = radix_chunks(paged_batches, BLOCK_K, PREFILL_CHUNK)
    replicas = [
        (f'paged bf16 chunk {PREFILL_CHUNK}', {},
         da.paged_decode_attention_kernel,
         (da.decode_attention_kernel, da.paged_verify_attention_kernel)),
        (f'spec bf16 drafter 1 chunk {PREFILL_CHUNK}',
         dict(spec_k=SPEC_K, drafter_layers=1),
         da.paged_verify_attention_kernel,
         (da.decode_attention_kernel, da.paged_decode_attention_kernel))]
    for label, kwargs, kernel_fn, idle_fns in replicas:
        stats, results = serve_phase(
            torch, ms_lib, params, label,
            dict(paged=True, prefill_chunk=PREFILL_CHUNK, **kwargs),
            paged_batches, kernel_fn, card, idle_fns=idle_fns)
        got = (stats['chunked_admissions'], stats['prefill_chunks'])
        if got != want or not want[0]:
            fail(f'{label}: (chunked admissions, prefill chunks) {got}, '
                 f'expected {want}')
        if stats['prefill_tokens_saved'] <= 0:
            fail(f'{label}: no prefix reuse: {stats}')
        pairs = [(body['prompt'], base['tokens'], res['tokens'])
                 for (body, base), (_, res) in zip(paged_results, results)]
        div = first_divergences(torch, llama, params, cfg16, pairs,
                                SPEC_PARITY_BF16_ULPS, label)
        print(f'[chunked] {label}: {got[0]} chunked admissions, {got[1]} '
              f'chunks, prefix hit tokens {stats["prefill_tokens_saved"]}; '
              f'{len(pairs) - len(div)}/{len(pairs)} requests token-'
              f'identical to the unchunked paged replica, {len(div)} near-'
              'tie divergences', flush=True)
    cfg32, p32 = fp32_cut(torch, params, cfg16)
    prompts = [body['prompt'] for body, _ in paged_results]
    tokens = {}
    for chunk in (0, PREFILL_CHUNK):
        eng = ms_lib.engine_lib.DecodeEngine(
            p32, cfg32, decode.DecodeConfig(max_len=MAX_LEN), 8,
            step_chunk=4, paged=True, prefill_chunk=chunk)
        tokens[chunk] = drain_engine(ms_lib, eng, prompts)
        st = eng.stats()
        del eng
    if not st['chunked_admissions']:
        fail(f'fp32 chunked engine chunked nothing: {st}')
    label = f'fp32 {SPEC_PARITY_LAYERS} layers chunk {PREFILL_CHUNK}'
    first_divergences(torch, llama, p32, cfg32,
                      list(zip(prompts, tokens[0], tokens[PREFILL_CHUNK])),
                      None, label)
    print(f'[chunked] {label}: {st["chunked_admissions"]} chunked '
          f'admissions, {st["prefill_chunks"]} chunks; tokens equal the '
          f'unchunked engine\'s in all {len(prompts)} requests', flush=True)
    del p32
    empty_cache(torch)


def stream_timed(port: int, body: dict, events: list) -> None:
    """POST a streamed /generate and append (host time, event) for each
    SSE event as it arrives, until the done event."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate',
        data=json.dumps({**body, 'stream': True}).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            if not line.startswith(b'data: '):
                continue
            event = json.loads(line[len(b'data: '):])
            events.append((time.perf_counter(), event))
            if event.get('done'):
                return


def start_streams(port: int, bodies) -> tuple:
    """One stream_timed thread per body: (threads, event lists)."""
    events = [[] for _ in bodies]
    threads = [threading.Thread(target=stream_timed, args=(port, b, ev),
                                daemon=True)
               for b, ev in zip(bodies, events)]
    for t in threads:
        t.start()
    return threads, events


def wait_for(cond, what: str, timeout: float = 120.0) -> float:
    """Poll ``cond`` until true; returns the seconds waited."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            fail(f'timed out waiting for {what}')
        time.sleep(0.005)
    return time.perf_counter() - t0


def join_all(threads, timeout: float = 600.0) -> None:
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            fail('a client thread did not finish')


def http_status(port: int, path: str, body=None):
    """(status, headers, text) of one request, error statuses included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def rand_prompt(rng, vocab: int, n: int) -> list:
    return [rng.randrange(vocab) for _ in range(n)]


def hol_phase(torch, ms_lib, params, card):
    """(c) Head-of-line, printed and not gated: HOL_LANES lanes decoding
    HOL_NEW tokens each when a HOL_PROMPT-token prompt arrives, on a
    paged replica with prefill_chunk PREFILL_CHUNK and then 0. Prints
    the decoding lanes' largest inter-token gap while the long prompt
    prefills and in a steady window of about three ticks before it
    arrives (all lanes admitted), its TTFT and its chunks, on the host
    clock. Tokens reach a lane in bursts of step_chunk, so a gap is the
    time between two engine ticks."""
    import random
    vocab = ms_lib.llama.CONFIGS[MODEL].vocab_size
    rng = random.Random(10)
    lanes = [{'prompt': rand_prompt(rng, vocab, 64),
              'max_new_tokens': HOL_NEW} for _ in range(HOL_LANES)]
    long_body = {'prompt': rand_prompt(rng, vocab, HOL_PROMPT),
                 'max_new_tokens': 16}
    out = {}
    for chunk in (PREFILL_CHUNK, 0):
        engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                     device=DEVICE, params=params,
                                     paged=True, prefill_chunk=chunk)
        server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
        port = server.start()
        try:
            threads, events = start_streams(port, lanes)
            wait_for(lambda: all(len(ev) >= 8 for ev in events),
                     'the decoding lanes')
            t_ready = time.perf_counter()
            # Three more bursts of step_chunk tokens: the window holds at
            # least one whole gap between ticks.
            wait_for(lambda: all(len(ev) >= 20 for ev in events),
                     'three more ticks')
            t_post = time.perf_counter()
            long_events = []
            stream_timed(port, long_body, long_events)
            join_all(threads)
        finally:
            server.stop()
        t_first = long_events[0][0]
        during = before = 0.0
        for ev in events:
            times = [t for t, _ in ev]
            if len(times) != HOL_NEW:
                fail(f'hol chunk {chunk}: a lane got {len(times)} tokens')
            for a, b in zip(times, times[1:]):
                if b > t_post and a < t_first:
                    during = max(during, b - a)
                elif a >= t_ready and b <= t_post:
                    before = max(before, b - a)
        out[chunk] = dict(gap_ms=during * 1e3, before_ms=before * 1e3,
                          ttft_ms=(t_first - t_post) * 1e3,
                          chunks=engine.stats()['prefill_chunks'])
        print(f'[hol] prefill_chunk {chunk}: {HOL_LANES} lanes decoding '
              f'{HOL_NEW} tokens, a {HOL_PROMPT}-token prompt arrives: '
              f'largest inter-token gap {out[chunk]["gap_ms"]:.1f} ms while '
              f'it prefills ({out[chunk]["before_ms"]:.1f} ms in the steady '
              f'window before), its TTFT {out[chunk]["ttft_ms"]:.1f} ms, '
              f'{out[chunk]["chunks"]} chunks; host clock, on {card}',
              flush=True)
    return out


def allocated(torch) -> int:
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()
    return 0


def supervision_phase(torch, ms_lib, da, params, paged_results,
                      dense_results, card):
    """(d) SKYTPU_CHAOS=engine_step_raise:1 armed while 8 lanes decode
    and one request waits in the queue, on a paged and a dense replica:
    the in-flight requests get their error within FAIL_FAST_SECONDS,
    ``restarts`` reads 1, the queued request gives phase 3's tokens for
    its prompt, device memory after the restart is at most the memory
    before the crash plus RESTART_MEM_SLACK and its peak during the
    restart stays below the memory before plus one cache (the old cache
    is freed before the new one is allocated), and the decode kernel ran
    n_layers x decode steps across the restart. Then, with
    SKYTPU_ENGINE_MAX_RESTARTS=0, one more crash fails the engine for
    good: /healthz 503, /generate 503 with Retry-After: 30."""
    import random
    from skypilot_tpu_torch.utils import chaos
    cfg = ms_lib.llama.CONFIGS[MODEL]
    rng = random.Random(11)
    # The queued prompts were prefilled cold by phase 3 (no prefix hit).
    replicas = [('paged', {'paged': True}, da.paged_decode_attention_kernel,
                 paged_results[2]),
                ('dense', {}, da.decode_attention_kernel, dense_results[0])]
    out = {}
    for label, kwargs, kernel_fn, (q_body, q_want) in replicas:
        engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                     device=DEVICE, params=params, **kwargs)
        server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
        port = server.start()
        before = kernel_fn.launches
        try:
            bodies = [{'prompt': rand_prompt(rng, cfg.vocab_size, 32),
                       'max_new_tokens': 1024} for _ in range(8)]
            threads, events = start_streams(port, bodies)
            wait_for(lambda: engine.active_slots() == 8 and
                     all(events), f'{label}: 8 decoding lanes')
            queued = {}
            q_thread = threading.Thread(
                target=lambda: queued.update(r=post(
                    port, {**q_body, 'stream': False})), daemon=True)
            q_thread.start()
            wait_for(lambda: engine.queue_depth() == 1,
                     f'{label}: a queued request')
            mem_before = allocated(torch)
            if torch.device(DEVICE).type == 'cuda':
                torch.cuda.reset_peak_memory_stats()
            chaos.reset()
            os.environ[chaos.CHAOS_ENV] = 'engine_step_raise:1'
            t_arm = time.perf_counter()
            restart_s = wait_for(lambda: engine.restart_count() == 1,
                                 f'{label}: the restart', FAIL_FAST_SECONDS)
            join_all(threads, FAIL_FAST_SECONDS)
            fail_s = max(ev[-1][0] for ev in events) - t_arm
            for ev in events:
                last = ev[-1][1]
                if not (last.get('done') and
                        'engine crashed' in str(last.get('error'))):
                    fail(f'{label}: in-flight request ended with {last}')
            if fail_s > FAIL_FAST_SECONDS:
                fail(f'{label}: in-flight errors took {fail_s:.1f}s')
            del os.environ[chaos.CHAOS_ENV]
            join_all([q_thread])
            if queued['r']['tokens'] != q_want['tokens']:
                fail(f'{label}: the queued request gave '
                     f'{queued["r"]["tokens"]}, phase 3 '
                     f'{q_want["tokens"]}')
            mem_after = allocated(torch)
            peak = (torch.cuda.max_memory_allocated()
                    if torch.device(DEVICE).type == 'cuda' else 0)
            cache_bytes = sum(t.nbytes for t in engine._cache.values())  # pylint: disable=protected-access
            if peak >= mem_before + cache_bytes:
                fail(f'{label}: {peak} bytes allocated at the peak of the '
                     f'restart, {mem_before} before it, the cache '
                     f'{cache_bytes}: old and new caches coexisted')
            stats = engine.stats()
            if stats['restarts'] != 1:
                fail(f'{label}: restarts {stats["restarts"]}')
            if mem_after > mem_before + RESTART_MEM_SLACK:
                fail(f'{label}: {mem_after} bytes allocated after the '
                     f'restart, {mem_before} before the crash')
            launches = kernel_fn.launches - before
            if launches != cfg.n_layers * stats['decode_steps']:
                fail(f'{label}: {kernel_fn.__name__} launched {launches} '
                     f'times over {stats["decode_steps"]} decode steps')
            # One more crash with no budget left: failed for good.
            os.environ['SKYTPU_ENGINE_MAX_RESTARTS'] = '0'
            chaos.reset()
            os.environ[chaos.CHAOS_ENV] = 'engine_step_raise:1'
            wait_for(lambda: engine.failed, f'{label}: permanent failure',
                     FAIL_FAST_SECONDS)
            health, _, text = http_status(port, '/healthz')
            gen, headers, _ = http_status(port, '/generate',
                                          {'prompt': [1, 2, 3]})
            if (health != 503 or
                    not text.startswith('engine failed permanently')):
                fail(f'{label}: /healthz {health} {text[:80]}')
            if gen != 503 or headers.get('Retry-After') != '30':
                fail(f'{label}: /generate {gen} {headers}')
        finally:
            os.environ.pop(chaos.CHAOS_ENV, None)
            os.environ.pop('SKYTPU_ENGINE_MAX_RESTARTS', None)
            chaos.reset()
            server.stop()
        out[label] = dict(restart_s=restart_s, fail_s=fail_s,
                          mem_before=mem_before, mem_after=mem_after,
                          peak=peak, cache_bytes=cache_bytes,
                          launches=launches)
        print(f'[supervise] {label}: crash armed with 8 lanes decoding and '
              f'1 queued; restarted in {restart_s:.3f}s, the 8 in-flight '
              f'errors within {fail_s:.3f}s, restarts=1, the queued '
              f'request gave phase 3\'s {len(q_want["tokens"])} tokens; '
              f'memory allocated {mem_before / 2**30:.3f} GiB before the '
              f'crash, {mem_after / 2**30:.3f} GiB after the restart, '
              f'{peak / 2**30:.3f} GiB at the peak (the cache '
              f'{cache_bytes / 2**30:.3f} GiB); '
              f'{kernel_fn.__name__} {launches} launches; then failed for '
              f'good at MAX_RESTARTS=0 (/healthz 503, /generate 503 '
              f'Retry-After 30); on {card}', flush=True)
    return out


def drain_phase(torch, ms_lib, da, params, card):
    """(e) POST /drain with 4 requests in flight on a paged replica: 202,
    the 4 complete with every token, new /generate calls 503 with
    Retry-After, /healthz 503, and the server stops by itself."""
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    rng = random.Random(12)
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params, paged=True)
    server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    before = da.paged_decode_attention_kernel.launches
    try:
        bodies = [{'prompt': rand_prompt(rng, cfg.vocab_size, 64),
                   'max_new_tokens': 64} for _ in range(4)]
        threads, events = start_streams(port, bodies)
        wait_for(lambda: engine.active_slots() == 4 and all(events),
                 'drain: 4 decoding lanes')
        status, _, text = http_status(port, '/drain', {})
        if status != 202 or json.loads(text)['state'] != 'draining':
            fail(f'drain: POST /drain {status} {text}')
        gen, headers, _ = http_status(port, '/generate', {'prompt': [1]})
        if gen != 503 or not headers.get('Retry-After'):
            fail(f'drain: /generate while draining {gen} {headers}')
        health, _, text = http_status(port, '/healthz')
        if health != 503 or not text.startswith('draining'):
            fail(f'drain: /healthz while draining {health} {text[:40]}')
        join_all(threads)
        for ev in events:
            if (len(ev) != 64 or ev[-1][1].get('finish_reason') != 'length'):
                fail(f'drain: a request got {len(ev)} events, last '
                     f'{ev[-1][1] if ev else None}')
        stop_s = wait_for(lambda: server.state == 'stopped',
                          'drain: the server to stop', 60)
    finally:
        server.stop()
    stats = engine.stats()
    launches = da.paged_decode_attention_kernel.launches - before
    if launches != cfg.n_layers * stats['decode_steps']:
        fail(f'drain: {launches} paged decode launches over '
             f'{stats["decode_steps"]} steps')
    print(f'[drain] 4 in flight: 202, each finished its 64 tokens, '
          f'/generate 503 with Retry-After {headers["Retry-After"]}, '
          f'/healthz 503; stopped {stop_s:.3f}s after the last token; on '
          f'{card}', flush=True)


# -------------------------------------------------------------- phase 11


P3 = ('p50', 'p95', 'p99')
# The reference replica's /slo body, key by key
# (skypilot_tpu/serve/model_server.py _handle_slo over
# observability/request_trace.RequestTelemetry.slo): the card host has no
# aiohttp and no jax to start the reference server.
SLO_KEYS = {
    'engine': None,
    'window': ('capacity', 'completed', 'span_seconds'),
    'in_flight': None, 'queued': None,
    'queue_wait_seconds': P3, 'prefill_seconds': P3, 'ttft_seconds': P3,
    'per_token_seconds': P3, 'total_seconds': P3,
    'rates': ('finished_total', 'rejected_total', 'error_total',
              'slow_total', 'reject_rate', 'error_rate'),
    'slo': ('slow_request_seconds', 'ttft_slo_seconds'),
    'resilience': ('server_state', 'drains_total', 'engine_restarts',
                   'engine_failed'),
    'spec': ('enabled', 'spec_k', 'drafter_layers', 'drafted_total',
             'accepted_total', 'accept_ratio', 'prefill_chunk',
             'prefill_chunks_total', 'chunked_admissions'),
    'cache': ('paged', 'prefix_hit_ratio', 'prefill_tokens_saved',
              'prompt_tokens_total', 'prefix_cache_blocks', 'radix_nodes',
              'prefix_evictions', 'prefix_fetch_hits',
              'prefix_fetch_misses', 'prefix_fetch_tokens', 'prefix_peers',
              'store_configured', 'store_in_backoff', 'store_fetch_hits',
              'store_fetch_misses', 'store_fetch_tokens', 'store_spills',
              'store_spill_tokens', 'store_spill_failures',
              'store_spill_drops'),
    'role': None,
    'handoff': ('completed', 'degraded', 'tokens_pushed', 'injections',
                'tokens_injected'),
    'store': ('hosting', 'configured_url', 'in_backoff', 'prewarms',
              'prewarm_tokens'),
    'steps': {'engine': None, 'capacity': None, 'steps_recorded': None,
              'stalls': None, 'stall_factor': None,
              'stall_min_seconds': None, 'rolling_median_seconds': None,
              'last_step_age_seconds': None, 'step_seconds': P3,
              'mean_step_seconds': None},
}
# (e) the burst whose ticks are timed: lanes x new tokens.
COST_LANES, COST_NEW = 8, 64
JOURNAL_STALL_SECONDS = 2.0


def key_tree(obj):
    """A JSON body's keys in SLO_KEYS's form: nested dicts where a value
    holds dicts, a tuple of keys where it holds scalars."""
    if not isinstance(obj, dict):
        return None
    subs = {k: key_tree(v) for k, v in obj.items()}
    if all(v is None for v in subs.values()):
        return tuple(obj)
    return subs


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition → {series with labels: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith('#'):
            series, value = line.rsplit(' ', 1)
            out[series] = float(value)
    return out


def get_json(port: int, path: str, body=None):
    status, _, text = http_status(port, path, body)
    if status != 200:
        fail(f'{path}: {status} {text[:200]}')
    return json.loads(text)


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.nbytes


def telemetry_replica(torch, ms_lib, tele, params, label, kwargs, batches,
                      kernel_fn, tmp, card):
    """(a)-(d) on one replica: a fresh registry and journal file, phase
    3's paged requests each with its own X-Request-Id, then the counters
    of /metrics against the kernel's launches and the clients' tokens,
    the device-memory split against the tensors' bytes, /slo's keys and
    window, /debug/*, and /journal with and without
    SKYTPU_JOURNAL_PEERS. Returns what (d) and the summary read."""
    metrics, journal = tele
    db = os.path.join(tmp, f'{label.replace(" ", "_")}.db')
    os.environ[journal.DB_PATH_ENV] = db
    metrics.set_registry(metrics.MetricsRegistry())
    # A stopped replica's engine and cache stay allocated until the cyclic
    # collector runs (the server and its HTTP server refer to each
    # other): collect them, so workspace reads this replica's own.
    gc.collect()
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params, **kwargs)
    server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    before = kernel_fn.launches
    n_layers = ms_lib.llama.CONFIGS[MODEL].n_layers
    replies = []
    try:
        for b, batch in enumerate(batches):
            out = [None] * len(batch)
            errors = []

            def run(i, body, rid):
                try:
                    out[i] = post(port, body, headers={'X-Request-Id': rid})
                except BaseException as e:  # noqa: BLE001 re-raised below
                    errors.append(e)

            rids = [f'p11-{label.split()[0]}-{b}-{i}'
                    for i in range(len(batch))]
            threads = [threading.Thread(target=run, args=(i, body, rid))
                       for i, (body, rid) in enumerate(zip(batch, rids))]
            for t in threads:
                t.start()
            join_all(threads, 900)
            if errors:
                raise errors[0]
            replies += list(zip(rids, out))
        n = len(replies)
        for rid, res in replies:
            if res['request_id'] != rid:
                fail(f'{label}: X-Request-Id {res["request_id"]} for {rid}')
        # A client wakes on its last token; the eviction's telemetry
        # follows on the engine thread.
        wait_for(lambda: get_json(port, '/slo')['window']['completed'] == n,
                 f'{label}: /slo to count {n} requests', 30)
        launches = kernel_fn.launches - before
        status, headers, text = http_status(port, '/metrics')
        if status != 200 or not headers['Content-Type'].startswith(
                'text/plain'):
            fail(f'{label}: /metrics {status} {headers}')
        m = parse_metrics(text)
        slo = get_json(port, '/slo')
        reqs = get_json(port, '/debug/requests?n=64')
        steps = get_json(port, '/debug/engine?n=32')
        status, _, _ = http_status(port, '/journal')
        if status != 404:
            fail(f'{label}: /journal without SKYTPU_JOURNAL_PEERS: {status}')
        os.environ[ms_lib.JOURNAL_PEERS_ENV] = 'http://127.0.0.1:1'
        try:
            trace = replies[-1][0]
            rows = get_json(port, '/journal', {'trace_id': trace})['events']
        finally:
            del os.environ[ms_lib.JOURNAL_PEERS_ENV]
    finally:
        server.stop()
    engine.flush_journal()
    compiles = journal.query(kinds=['engine.compile'], db_path=db,
                             limit=100000)
    hbm_row = journal.query(kinds=['engine.hbm'], db_path=db)[0]['payload']
    # (a) counters against launches and tokens.
    tokens = sum(len(res['tokens']) for _, res in replies)
    steps_total = m['skytpu_engine_steps_total']
    checks = {
        'steps_total x n_layers': (steps_total * n_layers, launches),
        'tokens_total': (m['skytpu_engine_tokens_total'], tokens),
        'admitted_total': (m['skytpu_engine_admitted_total'], n),
        'evicted_total': (m['skytpu_engine_evicted_total'], n),
        'ttft_seconds_count': (m['skytpu_engine_ttft_seconds_count'], n),
        'compiles_total': (m['skytpu_engine_compiles_total'],
                           len({json.dumps(r['payload'], sort_keys=True)
                                for r in compiles})),
    }
    for what, (got, want) in checks.items():
        if got != want or not want:
            fail(f'{label}: /metrics {what} {got}, expected {want}')
    # (b) device memory.
    pool_kind = 'paged_pool' if kwargs.get('paged') else 'kv_cache'
    hbm = {k: m[f'skytpu_engine_hbm_bytes{{kind="{k}"}}']
           for k in ('weights', pool_kind, 'workspace')}
    if (hbm['weights'] != tensor_bytes(params) or
            hbm[pool_kind] != tensor_bytes(engine._cache) or  # pylint: disable=protected-access
            hbm['workspace'] < 0 or
            hbm_row['workspace_measured'] != (
                torch.device(DEVICE).type == 'cuda') or
            hbm_row['per_device_bytes'] != {k: int(v)
                                            for k, v in hbm.items()}):
        fail(f'{label}: hbm {hbm} against weights {tensor_bytes(params)} '
             f'and {pool_kind} {tensor_bytes(engine._cache)}; engine.hbm '  # pylint: disable=protected-access
             f'{hbm_row}')
    # (c) /slo, /debug/* and the journal.
    if key_tree(slo) != SLO_KEYS:
        fail(f'{label}: /slo keys {key_tree(slo)}')
    traced = {r['trace_id'] for r in reqs['completed']}
    if not {rid for rid, _ in replies} <= traced:
        fail(f'{label}: /debug/requests lacks {set(r for r, _ in replies) - traced}')
    if not steps['step_profile']['recent']:
        fail(f'{label}: /debug/engine step_profile ring is empty')
    span = [r for r in rows if r['kind'] == 'span.start']
    kinds = [r['kind'] for r in rows]
    if (len(span) != 1 or span[0]['payload']['name'] != 'server.request' or
            not {'engine.admit', 'engine.evict'} <= set(kinds) or
            any(r['trace_id'] != trace or
                r['span_id'] != span[0]['span_id'] for r in rows)):
        fail(f'{label}: /journal for {trace}: {rows}')
    print(f'[telemetry] {label}: {n} requests, steps_total '
          f'{steps_total:.0f} x {n_layers} layers = {kernel_fn.__name__} '
          f'{launches} launches, tokens_total {tokens}, admitted = evicted '
          f'= ttft count = {n}, {len(compiles)} engine.compile rows; hbm '
          f'weights {hbm["weights"] / 2**30:.3f} GiB, {pool_kind} '
          f'{hbm[pool_kind] / 2**30:.3f} GiB, workspace '
          f'{hbm["workspace"] / 2**30:.3f} GiB; ttft_seconds '
          f'{slo["ttft_seconds"]} per_token_seconds '
          f'{slo["per_token_seconds"]}; /journal {trace}: {kinds}; '
          f'on {card}', flush=True)
    return {'metrics': m, 'slo': slo, 'launches': launches, 'hbm': hbm,
            'ttft': slo['ttft_seconds'], 'per_token':
            slo['per_token_seconds']}


def timed_ticks(engine) -> list:
    """Wrap ``engine.step`` (the loop calls it through the instance) to
    record each busy tick's host seconds; returns the list it fills."""
    ticks = []
    step = engine.step

    def timed():
        t0 = time.perf_counter()
        active = step()
        if active:
            ticks.append(time.perf_counter() - t0)
        return active

    engine.step = timed
    return ticks


def telemetry_cost_phase(torch, ms_lib, tele, params, tmp, card):
    """(e) Printed, not gated: one burst of COST_LANES x COST_NEW tokens
    on a paged replica with the journal on and with
    SKYTPU_JOURNAL_DISABLED=1, in turns: the median tick (host time of
    the busy engine steps) and the largest inter-token gap of each; then
    the same with journal_write_stall armed
    (SKYTPU_CHAOS_JOURNAL_STALL_SECONDS=2). The largest gap includes the
    ticks that admit the burst's prefills, so the stalled burst's is read
    against the others'."""
    import random
    from skypilot_tpu_torch.utils import chaos
    metrics, journal = tele
    os.environ[journal.DB_PATH_ENV] = os.path.join(tmp, 'cost.db')
    metrics.set_registry(metrics.MetricsRegistry())
    gc.collect()
    vocab = ms_lib.llama.CONFIGS[MODEL].vocab_size
    rng = random.Random(13)
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params, paged=True)
    server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    ticks = timed_ticks(engine)
    medians = {'on': [], 'off': [], 'stall': []}
    gaps = {'on': [], 'off': [], 'stall': []}

    def burst():
        bodies = [{'prompt': rand_prompt(rng, vocab, 32),
                   'max_new_tokens': COST_NEW} for _ in range(COST_LANES)]
        threads, events = start_streams(port, bodies)
        join_all(threads)
        for ev in events:
            if len(ev) != COST_NEW:
                fail(f'telemetry cost: a lane got {len(ev)} tokens')
        return max(b - a for ev in events
                   for (a, _), (b, _) in zip(ev, ev[1:])) * 1e3

    try:
        os.environ[chaos.JOURNAL_STALL_SECONDS_ENV] = str(
            JOURNAL_STALL_SECONDS)
        for mode in ('on', 'off', 'on', 'off', 'stall'):
            if mode == 'off':
                os.environ[journal.DISABLE_ENV] = '1'
            elif mode == 'stall':
                chaos.reset()
                os.environ[chaos.CHAOS_ENV] = 'journal_write_stall:1.0'
            del ticks[:]
            gaps[mode].append(burst())
            os.environ.pop(journal.DISABLE_ENV, None)
            medians[mode].append(statistics.median(ticks) * 1e3)
        del os.environ[chaos.CHAOS_ENV]
        # Recovery: once the stalled flush ends, the next flush with rows
        # is fast and journals the one journal.stall row.
        time.sleep(JOURNAL_STALL_SECONDS + 0.2)
        post(port, {'prompt': [1, 2, 3], 'max_new_tokens': 2})
        stall_rows = []
        deadline = time.perf_counter() + 10
        while not stall_rows and time.perf_counter() < deadline:
            engine.flush_journal()
            stall_rows = journal.query(kinds=['journal.stall'],
                                       db_path=os.environ[
                                           journal.DB_PATH_ENV])
            time.sleep(0.05)
        jstats = engine.journal_stats()
    finally:
        os.environ.pop(chaos.CHAOS_ENV, None)
        os.environ.pop(chaos.JOURNAL_STALL_SECONDS_ENV, None)
        os.environ.pop(journal.DISABLE_ENV, None)
        chaos.reset()
        server.stop()
    out = {'tick_ms': medians, 'max_gap_ms': gaps, 'stall_journal': jstats,
           'stall_rows': [r['payload'] for r in stall_rows]}

    def ms_list(xs):
        return '/'.join(f'{x:.1f}' for x in xs)

    print(f'[telemetry] cost, {COST_LANES} x {COST_NEW}-token bursts in '
          f'turns, median tick / largest inter-token gap: journal on '
          f'{ms_list(medians["on"])} / {ms_list(gaps["on"])} ms, '
          f'SKYTPU_JOURNAL_DISABLED=1 {ms_list(medians["off"])} / '
          f'{ms_list(gaps["off"])} ms, journal_write_stall '
          f'({JOURNAL_STALL_SECONDS:.0f} s a flush) '
          f'{ms_list(medians["stall"])} / {ms_list(gaps["stall"])} ms; '
          f'journal {jstats}, journal.stall rows {out["stall_rows"]}; host '
          f'clock, on {card}', flush=True)
    return out


def telemetry_phase(torch, ms_lib, da, params, paged_batches, card):
    """Phase 11: the serving telemetry on paged, spec, dense replicas and
    its cost; launch counts reset by the caller."""
    from skypilot_tpu_torch.observability import journal, metrics
    tele = (metrics, journal)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_journal_')
    prev_registry = metrics.get_registry()
    prev_db = os.environ.get(journal.DB_PATH_ENV)
    try:
        paged = telemetry_replica(
            torch, ms_lib, tele, params, 'paged bf16', {'paged': True},
            paged_batches, da.paged_decode_attention_kernel, tmp, card)
        spec = telemetry_replica(
            torch, ms_lib, tele, params, 'spec bf16',
            {'paged': True, 'spec_k': SPEC_K, 'drafter_layers': 1},
            paged_batches, da.paged_verify_attention_kernel, tmp, card)
        m, block = spec['metrics'], spec['slo']['spec']
        drafted = m['skytpu_engine_spec_drafted_total']
        accepted = m['skytpu_engine_spec_accepted_total']
        ratio = m['skytpu_engine_spec_accept_ratio']
        if (drafted != block['drafted_total'] or
                accepted != block['accepted_total'] or not drafted or
                abs(ratio - accepted / drafted) > 1e-12):
            fail(f'spec: counters {drafted} {accepted} {ratio} against '
                 f'/slo spec {block}')
        print(f'[telemetry] spec: drafted {drafted:.0f} accepted '
              f'{accepted:.0f} ratio {ratio} equal /slo spec; verify '
              f'launches = n_layers x rounds', flush=True)
        dense = telemetry_replica(
            torch, ms_lib, tele, params, 'dense bf16', {}, paged_batches,
            da.decode_attention_kernel, tmp, card)
        cost = telemetry_cost_phase(torch, ms_lib, tele, params, tmp, card)
    finally:
        os.environ.pop(journal.DB_PATH_ENV, None)
        if prev_db is not None:
            os.environ[journal.DB_PATH_ENV] = prev_db
        metrics.set_registry(prev_registry)
        shutil.rmtree(tmp, ignore_errors=True)
    return {'paged': {k: paged[k] for k in ('hbm', 'ttft', 'per_token')},
            'spec': {k: spec[k] for k in ('ttft', 'per_token')},
            'dense_hbm': dense['hbm'], 'cost': cost}


# -------------------------------------------------------------- phase 12


# (a) the int8 library GEMM at the serving shapes: rows (decode's 8
# slots, verify's 8 x 5, a prefill) against llama3-8b's (K, N).
INT8_ROWS = (8, 40, 1000)
INT8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# H100 SXM dense int8 tensor-core peak (data sheet), operations/s.
PEAK_INT8_OPS = 1979e12
# (b) the int8 replicas' weights, predicted from the config before the
# first run (PERF.md): int8 layer weights + fp32 scales + the bf16
# embedding, lm_head and norms.
INT8_WEIGHTS_PREDICTED = 9_086_705_664
# (c) int8 weights, kernel vs plain decode attention, max |dlogit| over
# max |logit|, held at INT8_E2E_LAYERS layers. Dynamic int8 activation
# quantisation is discontinuous: a one-ulp difference that carries a row
# value across a rounding edge moves it by a whole int8 step (1/127 of
# the row's largest value), and each layer adds such steps. At 32 random
# layers the two paths part by 0.263 (dense and paged), as far as int8
# weights part from bf16 ones (0.347), so no bound there separates a
# right kernel from a wrong one; that reading is printed, not held. At 2
# layers a probe read 0.039-0.054 and this phase 0.0536, dense and paged
# (H100 80GB HBM3, 700 W); the bound is about twice that, and a planted
# kernel that reads the wrong KV head (1.381 there) must break it in
# the same run.
INT8_E2E_LAYERS = 2
INT8_E2E_REL_TOL = 0.1
# (d) the params checkpoint: llama3-8b's bf16 params are 16.06 GB.
PARAMS_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'build', 'chip_smoke_params')
PARAMS_CKPT_FREE = 17 * 10**9


def int8_gemm_phase(torch, quant, card):
    """(a) The int8 route (row quantisation, cuBLASLt's int8 GEMM, the
    rescale) against its twin (the same over an exact fp64 product),
    bit for bit, at INT8_ROWS x INT8_SHAPES; the GEMM's device time,
    the whole int8 matmul's, bf16 ``x @ w``'s, and the GEMM's bound
    (int8 weight, int8 rows and int32 result bytes over the HBM rate,
    or 2MKN over the int8 peak), and the GEMM over a row-major weight,
    the layout the wrapper refuses. Returns the rows."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(1212)
    rows = []
    for k, n in INT8_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).bfloat16()
        qw = quant.quantize_int8(w, 0)
        for m in INT8_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            got = quant.int8_matmul(x, qw)
            want = quant.int8_matmul_plain(x, qw)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                fail(f'int8 M={m} K={k} N={n}: the library route and its '
                     f'twin differ (max '
                     f'{(got.float() - want.float()).abs().max().item()})')
            xq, _ = quant._quantize_rows(x)  # pylint: disable=protected-access
            gemm_ms = device_ms(lambda: quant.int8_gemm_library(xq,
                                                                qw.values))
            # The layout the wrapper refuses: the same GEMM over a
            # row-major copy of the weight (rows padded alike).
            xp = torch.nn.functional.pad(
                xq, (0, 0, 0, max(0, quant.LIBRARY_MIN_ROWS - m)))
            wr = qw.values.contiguous()
            row_major_ms = device_ms(lambda: torch._int_mm(xp, wr))  # pylint: disable=protected-access
            del xp, wr
            matmul_ms = device_ms(lambda: quant.int8_matmul(x, qw))
            bf16_ms = device_ms(lambda: x @ w)
            t_bytes = (k * n + m * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * m * k * n / PEAK_INT8_OPS * 1e3
            bound = max(t_bytes, t_ops)
            bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
            print(f'[phase 12] int8 M={m} K={k} N={n}: library route '
                  f'bitwise equal to its twin; GEMM device_ms={gemm_ms:.4f}'
                  f' (bound {bound:.4f}, {bound_by}; at {bound / gemm_ms:.3f}'
                  f' of it; row-major weight {row_major_ms:.4f}), whole '
                  f'int8 matmul {matmul_ms:.4f}, bf16 x @ w {bf16_ms:.4f}; '
                  f'on {card}', flush=True)
            rows.append(dict(m=m, k=k, n=n, gemm_ms=gemm_ms,
                             row_major_ms=row_major_ms, matmul_ms=matmul_ms,
                             bf16_ms=bf16_ms, bound_ms=bound,
                             bound_by=bound_by))
        del w, qw
    torch.cuda.empty_cache()
    return rows


def int8_weight_bytes(llama, decode, cfg) -> int:
    """The int8 replica's weights from the config's shapes: int8 values
    and fp32 [L, 1, out] scales for the quantised layer weights, the
    model dtype's bytes for the rest."""
    total = 0
    for name, shape in llama.param_shapes(cfg)['layers'].items():
        n = math.prod(shape)
        total += (n + 4 * shape[0] * shape[2]
                  if name in decode.QUANTIZED_WEIGHTS else 2 * n)
    return total + sum(2 * math.prod(shape)
                       for name, shape in llama.param_shapes(cfg).items()
                       if name != 'layers')


def int8_serve_phase(torch, ms_lib, quant, da, params, dense_results,
                     paged_batches, card):
    """(b) ``build_engine(int8=True)`` replicas, dense, paged and spec
    (spec_k SPEC_K, drafter depth 1), answering phase 3's requests:
    token counts and the attention kernel's launches (serve_phase), the
    int8 GEMM's launches exactly 7 per layer pass (n_layers per prefill
    and per decode step or verify, plus the drafter's depth x SPEC_K a
    round), and the weights' bytes in the HBM split against the config
    and the prediction. Returns {label: (stats, results)}."""
    cfg = ms_lib.llama.CONFIGS[MODEL]
    n_w = len(ms_lib.decode.QUANTIZED_WEIGHTS)
    want_bytes = int8_weight_bytes(ms_lib.llama, ms_lib.decode, cfg)
    dense_batch = [body for body, _ in dense_results]
    kernels = (da.decode_attention_kernel, da.paged_decode_attention_kernel,
               da.paged_verify_attention_kernel)
    replicas = (
        ('dense int8-weights', {}, [dense_batch], kernels[0], 0),
        ('paged int8-weights', {'paged': True}, paged_batches, kernels[1], 0),
        ('spec int8-weights', {'paged': True, 'spec_k': SPEC_K,
                               'drafter_layers': 1}, paged_batches,
         kernels[2], 1))
    out = {}
    for label, kwargs, batches, kernel, drafter in replicas:
        before = quant.int8_gemm_library.launches
        stats, results = serve_phase(
            torch, ms_lib, params, label, {'int8': True, **kwargs}, batches,
            kernel, card, idle_fns=[k for k in kernels if k is not kernel])
        gemms = quant.int8_gemm_library.launches - before
        steps = stats['decode_steps']
        expect = n_w * (cfg.n_layers * (steps + stats['admitted']) +
                        drafter * SPEC_K * steps)
        if gemms != expect:
            fail(f'{label}: the int8 GEMM launched {gemms} times, expected '
                 f'{n_w} x (n_layers x ({steps} steps + '
                 f'{stats["admitted"]} prefills) + {drafter} x {SPEC_K} x '
                 f'{steps}) = {expect}')
        if stats['weights_bytes'] != want_bytes:
            fail(f'{label}: weights {stats["weights_bytes"]} bytes in the '
                 f'HBM split, the config gives {want_bytes}')
        print(f'[phase 12] {label}: int8 GEMM launches {gemms} = {expect} '
              f'({n_w} a layer pass); weights {stats["weights_bytes"]} '
              f'bytes (predicted {INT8_WEIGHTS_PREDICTED}); built and '
              f'quantised in {stats["build_s"]:.2f}s; on {card}',
              flush=True)
        out[label] = (stats, results)
    return out


def wrong_head_kernel(torch, fn, cfg):
    """``fn`` (a decode attention dispatcher) made into a planted wrong
    kernel: query head j reads KV head j % n_kv_heads instead of
    j // group, the kernel still launched."""
    g = cfg.n_heads // cfg.n_kv_heads
    perm = torch.arange(cfg.n_heads).reshape(g, cfg.n_kv_heads).T.reshape(-1)
    inv = torch.argsort(perm)

    def planted(q, *args, **kwargs):
        out = fn(q[..., perm.to(q.device), :].contiguous(), *args, **kwargs)
        return out[..., inv.to(q.device), :]
    return planted


def int8_e2e_phase(torch, decode, llama, qparams, card):
    """(c) The int8 weights teacher-forced through the dense and paged
    decode steps under 'kernel' and 'plain' decode attention (the int8
    GEMM is the same on both paths): held to phase 4's rule at
    INT8_E2E_REL_TOL on the first INT8_E2E_LAYERS layers, where a
    planted wrong-head kernel must break the bound; at full depth
    printed, not held. Returns the held and the full-depth readings."""
    import dataclasses
    cfg = llama.CONFIGS[MODEL]
    case = forced_case(torch, cfg)
    cut = dataclasses.replace(cfg, n_layers=INT8_E2E_LAYERS)
    shallow = {**qparams, 'layers': {k: w[:INT8_E2E_LAYERS] for k, w in
                                     qparams['layers'].items()}}
    ops = decode.decode_attention_ops
    out = {'held': 0.0, 'planted': math.inf, 'full': 0.0}
    for paged in (False, True):
        label = f'int8-weights {"paged" if paged else "dense"}'
        kl, pl = (teacher_forced(torch, decode, shallow, cut, case, paged,
                                 impl) for impl in ('kernel', 'plain'))
        rel = e2e_check(torch, kl, pl, INT8_E2E_REL_TOL,
                        f'{label} {INT8_E2E_LAYERS} layers')
        out['held'] = max(out['held'], rel)
        _, msg = twin_error(kl, pl, 'bf16')
        print(f'[phase 12] {label} {INT8_E2E_LAYERS} layers kernel vs '
              f'plain, twin_error statistics: {msg}; on {card}', flush=True)
        name = 'paged_decode_attention' if paged else 'decode_attention'
        real = getattr(ops, name)
        setattr(ops, name, wrong_head_kernel(torch, real, cfg))
        try:
            wl = teacher_forced(torch, decode, shallow, cut, case, paged,
                                'kernel')
        finally:
            setattr(ops, name, real)
        planted = ((wl - pl).abs().max() / pl.abs().max()).item()
        print(f'[phase 12] {label} {INT8_E2E_LAYERS} layers, a planted '
              f'kernel reading the wrong KV head: max|dlogit| / max|logit| '
              f'{planted:.4e} against the bound {INT8_E2E_REL_TOL}; on '
              f'{card}', flush=True)
        if not planted > INT8_E2E_REL_TOL:
            fail(f'{label}: a wrong-head kernel reads {planted} of '
                 f'max|logit|, within the bound {INT8_E2E_REL_TOL}: the '
                 f'check cannot tell it from the right one')
        out['planted'] = min(out['planted'], planted)
        kl, pl = (teacher_forced(torch, decode, qparams, cfg, case, paged,
                                 impl) for impl in ('kernel', 'plain'))
        rel = ((kl - pl).abs().max() / pl.abs().max()).item()
        top1 = (kl.argmax(-1) == pl.argmax(-1)).float().mean().item()
        print(f'[phase 12] {label} {cfg.n_layers} layers kernel vs plain '
              f'(report only): max|dlogit| / max|logit| {rel:.4e}, top-1 '
              f'agreement {top1:.4f} of {kl.shape[0] * kl.shape[1]} '
              f'positions; on {card}', flush=True)
        out['full'] = max(out['full'], rel)
        del kl, pl, wl
    empty_cache(torch)
    return out


class _LogLines(logging.Handler):
    """The messages a logger emits while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def restore_phase(torch, ms_lib, da, train, params, int8_dense, card):
    """(d) llama3-8b's bf16 params (phase 3's, drawn from seed 0) saved as
    a params checkpoint, then a replica built the CLI's way,
    ``build_engine(checkpoint_dir=..., int8=True, seed=1)`` with no
    params: it logs the restored step and its greedy tokens equal (b)'s
    dense int8 replica's on the same prompts, while the same build
    without ``checkpoint_dir`` (seed 1's own weights) gives other
    tokens. A trainer checkpoint handed to the same call raises
    ValueError. Fails when the disk has less than PARAMS_CKPT_FREE bytes
    free. Returns the seconds and bytes."""
    ckpt = ms_lib.checkpoint
    os.makedirs(PARAMS_CKPT_DIR, exist_ok=True)
    free = shutil.disk_usage(PARAMS_CKPT_DIR).free
    if free < PARAMS_CKPT_FREE:
        fail(f'restore: {free / 1e9:.1f} GB free under {PARAMS_CKPT_DIR}, '
             f'the params checkpoint needs {PARAMS_CKPT_FREE / 1e9:.0f} GB')
    trainer_dir = os.path.join(PARAMS_CKPT_DIR, 'trainer')
    want_stats, want = int8_dense
    prompts = [[body for body, _ in want]]

    def differing(got):
        return sum(a['tokens'] != b['tokens']
                   for (_, a), (_, b) in zip(want, got))

    logs = _LogLines()
    server_logger = logging.getLogger(ms_lib.__name__)
    try:
        t0 = time.perf_counter()
        path = ckpt.save_params(PARAMS_CKPT_DIR, params, 1)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, ckpt.STATE_FILE))
        print(f'[phase 12] restore: saved the {MODEL} params ({nbytes} '
              f'bytes) in {save_s:.2f}s; on {card}', flush=True)
        server_logger.addHandler(logs)
        level = server_logger.level
        server_logger.setLevel(logging.INFO)
        try:
            stats, got = serve_phase(
                torch, ms_lib, None, 'restored int8-weights',
                {'int8': True, 'checkpoint_dir': PARAMS_CKPT_DIR,
                 'seed': 1}, prompts, da.decode_attention_kernel, card)
        finally:
            server_logger.removeHandler(logs)
            server_logger.setLevel(level)
        restored_line = f'Restored checkpoint step 1 from {PARAMS_CKPT_DIR}.'
        if restored_line not in logs.lines:
            fail(f'restore: no "{restored_line}" line; the replica logged '
                 f'{logs.lines}')
        if differing(got):
            fail(f'restore: {differing(got)} of {len(got)} replies differ '
                 f'from the in-memory int8 replica\'s')
        _, own = serve_phase(torch, ms_lib, None, 'seed-1 int8-weights',
                             {'int8': True, 'seed': 1}, prompts,
                             da.decode_attention_kernel, card)
        if not differing(own):
            fail('restore: a replica of seed 1\'s own weights gives the '
                 'restored tokens, so they do not show the restore')
        print(f'[phase 12] restore: the restored int8 replica (seed 1) '
              f'logged "{restored_line}" and its {len(got)} replies equal '
              f'the in-memory one\'s token for token; the same build '
              f'without the checkpoint differs in {differing(own)} of '
              f'{len(own)}; restore + quantise {stats["build_s"]:.2f}s '
              f'(quantise alone {want_stats["build_s"]:.2f}s); on {card}',
              flush=True)
        state = train.init_train_state(ms_lib.llama.CONFIGS['debug'],
                                       train.TrainConfig(), DEVICE)
        ckpt.save(trainer_dir, state, 1)
        try:
            ms_lib.build_engine(MODEL, 8, MAX_LEN, int8=True, device=DEVICE,
                                checkpoint_dir=trainer_dir)
        except ValueError as e:
            print(f'[phase 12] restore: a trainer checkpoint raises '
                  f'ValueError ({str(e)[:100]})', flush=True)
        else:
            fail('restore: a trainer checkpoint was served')
    finally:
        shutil.rmtree(PARAMS_CKPT_DIR, ignore_errors=True)
    empty_cache(torch)
    return {'save_s': save_s, 'bytes': nbytes,
            'restore_build_s': stats['build_s']}


def int8_phase(torch, ms_lib, quant, da, decode, llama, train, params,
               dense_results, paged_batches, phase5, card):
    """Phase 12: int8 weights and checkpoint restore at llama3-8b's full
    width and depth; launch counts reset by the caller."""
    t0 = time.perf_counter()

    def took(part):
        print(f'[time] phase 12 {part} done at '
              f'{time.perf_counter() - t0:.1f}s', flush=True)

    gemm_rows = int8_gemm_phase(torch, quant, card)
    took('(a)')
    served = int8_serve_phase(torch, ms_lib, quant, da, params,
                              dense_results, paged_batches, card)
    took('(b) serving')
    qparams = decode.quantize_params(params)
    prof = profile_phase(torch, decode, llama, qparams, card, 'int8')
    took('(b) profile')
    for kind, row in prof.items():
        bf16 = phase5.get(kind, {})
        print(f'[phase 12] {kind} decode step, int8 weights against bf16 '
              f'(phase 5, this run): GEMMs {row["gemm_ms"]:.3f} against '
              f'{bf16.get("gemm_ms", float("nan")):.3f} ms/step of device '
              f'time, device busy {row["busy_ms"]:.3f} against '
              f'{bf16.get("busy_ms", float("nan")):.3f}, '
              f'{row["launches"]:.0f} against '
              f'{bf16.get("launches", float("nan")):.0f} kernels/step, host '
              f'clock {row["host_ms"]:.3f} against '
              f'{bf16.get("host_ms", float("nan")):.3f} ms; on {card}',
              flush=True)
    e2e = int8_e2e_phase(torch, decode, llama, qparams, card)
    took('(c)')
    del qparams
    empty_cache(torch)
    restored = restore_phase(torch, ms_lib, da, train, params,
                             served['dense int8-weights'], card)
    took('(d)')
    return {'gemm': gemm_rows, 'profile': prof, 'e2e': e2e,
            'restore': restored}


# -------------------------------------------------------------- phase 13


# The shared prefix: 8 blocks of 128 at llama3-8b width; the owner's
# tail and the fetcher's four, all inside one block, so the fetcher's
# later prompts hit its radix cache and only its first one fetches.
PREFIX_LEN = 1024
PREFIX_OWNER_TAIL = 24
PREFIX_TAILS = (16, 24, 32, 40)
# The fetcher's budget: large enough that the fetch of 8 blocks (134 MB
# raw in bf16, ~179 MB of base64 JSON) completes; a second fetcher keeps
# the default (0.5 s) and its outcome is printed.
PREFIX_FETCH_BUDGET = 60.0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def timed_stream(port: int, body: dict, rid: str) -> tuple:
    """A streamed /generate with ``X-Request-Id: rid``: (tokens, seconds
    to the first token on the client)."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate',
        data=json.dumps({**body, 'stream': True}).encode(),
        headers={'Content-Type': 'application/json', 'X-Request-Id': rid})
    t0 = time.perf_counter()
    ttft, tokens = None, []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            if not line.startswith(b'data: '):
                continue
            event = json.loads(line[len(b'data: '):])
            if 'error' in event:
                fail(f'request {rid}: {event}')
            if ttft is None:
                ttft = time.perf_counter() - t0
            tokens.append(event['token'])
            if event.get('done'):
                break
    if len(tokens) != body['max_new_tokens']:
        fail(f'request {rid}: {len(tokens)} tokens, expected '
             f'{body["max_new_tokens"]}')
    return tokens, ttft


class PrefixReplica:
    """One paged llama3-8b replica of phase 13 on a local port, built the
    way a user starts one (``build_engine`` with ``prefix_peers``; the
    budget through ``SKYTPU_PREFIX_FETCH_BUDGET_SECONDS``)."""

    def __init__(self, ms_lib, params, kv, port, peers=None, budget=None):
        env_name = 'SKYTPU_PREFIX_FETCH_BUDGET_SECONDS'
        if budget is not None:
            os.environ[env_name] = str(budget)
        try:
            self.engine = ms_lib.build_engine(
                MODEL, 8, MAX_LEN, step_chunk=4, device=DEVICE,
                params=params, paged=True, kv_int8=kv == 'int8',
                prefix_peers=peers)
        finally:
            os.environ.pop(env_name, None)
        self.server = ms_lib.ModelServer(self.engine, port,
                                         host='127.0.0.1')
        self.port = self.server.start()
        self.url = f'http://127.0.0.1:{self.port}'

    def serve(self, bodies, rid: str) -> list:
        """Answer ``bodies[0]`` alone (the admission that fetches, so its
        first-token time is its own), then the rest concurrently;
        [(tokens, ttft)] in order, request ids ``rid-0``, ``rid-1``..."""
        first = timed_stream(self.port, bodies[0], f'{rid}-0')
        out = [first] + [None] * (len(bodies) - 1)
        errors = []

        def run(i, body):
            try:
                out[i] = timed_stream(self.port, body, f'{rid}-{i}')
            except BaseException as e:  # noqa: BLE001 re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i, b))
                   for i, b in enumerate(bodies) if i]
        for t in threads:
            t.start()
        join_all(threads)
        if errors:
            raise errors[0]
        return out

    def fetch_rows(self, rid: str) -> list:
        """The ``engine.prefix_fetch`` rows of request ``rid`` through
        /journal, which a replica with prefix peers opens."""
        rows = get_json(self.port, '/journal',
                        {'trace_id': rid,
                         'kinds': 'engine.prefix_fetch'})['events']
        return [r['payload'] for r in rows]

    def stop(self) -> dict:
        self.server.stop()
        return self.engine.stats()


def prefix_fetch_phase(torch, ms_lib, da, params, card):
    """Phase 13: the cross-replica prefix fetch at llama3-8b width, bf16
    and int8 K/V; launch counts reset by the caller. Returns the printed
    numbers by K/V dtype."""
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    rng = random.Random(13)
    out = {}
    decode_steps = 0
    for kv in ('bf16', 'int8'):
        prefix = rand_prompt(rng, cfg.vocab_size, PREFIX_LEN)

        def body(tail):
            return {'prompt': prefix + rand_prompt(rng, cfg.vocab_size,
                                                    tail),
                    'max_new_tokens': N_NEW}

        owner_body = body(PREFIX_OWNER_TAIL)
        bodies = [body(n) for n in PREFIX_TAILS]
        owner_port, fetch_port = free_port(), free_port()
        owner_url = f'http://127.0.0.1:{owner_port}'
        fetch_url = f'http://127.0.0.1:{fetch_port}'
        fleet = [owner_url, fetch_url]
        # The owner and the fetcher share one fleet list, as a deployment
        # writes it: each finds its own address in it and skips it.
        owner = PrefixReplica(ms_lib, params, kv, owner_port, peers=fleet)
        fetcher = PrefixReplica(ms_lib, params, kv, fetch_port, peers=fleet,
                                budget=PREFIX_FETCH_BUDGET)
        replicas = [owner, fetcher]
        try:
            owner.serve([owner_body], f'p13-{kv}-owner')
            probe = ms_lib.engine_lib.Request(bodies[0]['prompt'], 1)
            tried = fetcher.engine._prefix_fetch_peers(probe)  # pylint: disable=protected-access
            if tried != [owner_url]:
                fail(f'{kv}: the fetcher would ask {tried}, expected only '
                     f'the owner {owner_url} (its own URL excluded)')
            fetched = fetcher.serve(bodies, f'p13-{kv}-fetch')
            slo = get_json(fetcher.port, '/slo')['cache']
            rows = [r for i in range(len(bodies))
                    for r in fetcher.fetch_rows(f'p13-{kv}-fetch-{i}')]
            decode_steps += fetcher.stop()['decode_steps']
            replicas.remove(fetcher)
            # The wire's cost apart, measured by a client of the owner.
            t_wire = time.perf_counter()
            status, _, text = http_status(
                owner.port, '/prefix_blocks',
                {'prompt': prefix, 'from_tokens': 0, 'budget_seconds': 60})
            wire_s = time.perf_counter() - t_wire
            if status != 200:
                fail(f'{kv}: /prefix_blocks {status} {text[:200]}')
            wire_bytes = len(text)
            payload = ms_lib.prefix_transfer.decode_payload(json.loads(text))
            raw_bytes = sum(a.nbytes for a in payload['arrays'].values())
            del text, payload
            # (c) the fetcher's 8 blocks are the owner's, every plane (the
            # owner's read through its loop, the fetcher's stopped).
            mine = fetcher.engine._export_prefix_now(prefix, 0)  # pylint: disable=protected-access
            theirs = owner.engine.export_prefix_blocks(prefix, 0, 60.0)
            if (mine is None or theirs is None or
                    mine['matched_tokens'] != PREFIX_LEN or
                    theirs['matched_tokens'] != PREFIX_LEN):
                fail(f'{kv}: the prefix is not held whole by both')
            for name, t in theirs['arrays'].items():
                if not torch.equal(mine['arrays'][name], t):
                    fail(f'{kv}: fetched {name} differs from the owner\'s')
            planes = sorted(theirs['arrays'])
            del mine, fetcher
            gc.collect()
            # (b) one fetch, a hit of the whole prefix, journaled.
            hits = [r for r in rows if r.get('outcome') == 'hit']
            if (slo['prefix_fetch_hits'] != 1 or
                    slo['prefix_fetch_tokens'] != PREFIX_LEN or
                    slo['prefix_fetch_misses'] != 0 or len(hits) != 1 or
                    hits[0]['peer'] != owner_url or
                    hits[0]['tokens_gained'] != PREFIX_LEN):
                fail(f'{kv}: fetch counters {slo}, rows {rows}')
            # The controls: "warm" holds the prefix by its own prefill of
            # the owner's prompt, so its first prompt takes the fetcher's
            # path (a radix hit, then the suffix); "cold" prefills
            # everything locally.
            warm = PrefixReplica(ms_lib, params, kv, 0)
            replicas.append(warm)
            (_, local_ttft), = warm.serve([owner_body], f'p13-{kv}-warm-own')
            warm_out = warm.serve(bodies, f'p13-{kv}-warm')
            decode_steps += warm.stop()['decode_steps']
            cold = PrefixReplica(ms_lib, params, kv, 0)
            replicas.append(cold)
            cold_out = cold.serve(bodies, f'p13-{kv}-cold')
            decode_steps += cold.stop()['decode_steps']
            # (a) every prompt's tokens are the warm control's.
            for i, ((got, _), (want, _)) in enumerate(zip(fetched,
                                                         warm_out)):
                if got != want:
                    fail(f'{kv}: prompt {i} over the fetched prefix gave '
                         f'{got[:8]}..., the control {want[:8]}...')
            # A fetcher left at the default budget: outcome printed; its
            # tokens are the warm control's on a hit, else the cold one's.
            default_port = free_port()
            dflt = PrefixReplica(
                ms_lib, params, kv, default_port,
                peers=[owner_url, f'http://127.0.0.1:{default_port}'])
            replicas.append(dflt)
            dflt_out = dflt.serve(bodies, f'p13-{kv}-default')
            dflt_rows = dflt.fetch_rows(f'p13-{kv}-default-0')
            decode_steps += dflt.stop()['decode_steps']
            outcome = dflt_rows[-1]['outcome'] if dflt_rows else None
            ref = warm_out if outcome == 'hit' else cold_out
            for i, ((got, _), (want, _)) in enumerate(zip(dflt_out, ref)):
                if got != want:
                    fail(f'{kv}: default-budget fetcher ({outcome}) prompt '
                         f'{i} differs from its control')
            decode_steps += owner.stop()['decode_steps']
            replicas = []
        finally:
            for r in replicas:
                r.server.stop()
        out[kv] = {
            'fetch_seconds': hits[0]['seconds'],
            'fetch_ttft_s': fetched[0][1],
            'local_prefill_ttft_s': local_ttft,
            'cold_ttft_s': cold_out[0][1],
            'warm_ttft_s': warm_out[0][1],
            'payload_json_bytes': wire_bytes,
            'payload_raw_bytes': raw_bytes,
            'wire_client_s': wire_s,
            'default_budget': {'outcome': outcome,
                               'seconds': (dflt_rows[-1]['seconds']
                                           if dflt_rows else None)},
            'planes': planes,
        }
        print(f'[prefix] {kv}: fetch of {PREFIX_LEN} tokens '
              f'{hits[0]["seconds"]:.3f}s (journal), first-token '
              f'{fetched[0][1]:.3f}s over the fetched prefix against '
              f'{local_ttft:.3f}s for the owner\'s prompt prefilled '
              f'locally and {cold_out[0][1]:.3f}s cold for the same '
              f'prompt; payload {wire_bytes} bytes of JSON for '
              f'{raw_bytes} raw, a client read it in {wire_s:.3f}s; '
              f'default 0.5s budget: {outcome}; on {card}', flush=True)
        del owner, theirs
        gc.collect()
        empty_cache(torch)
    n_layers = cfg.n_layers
    launched = da.paged_decode_attention_kernel.launches
    if launched != n_layers * decode_steps or not decode_steps:
        fail(f'phase 13: paged decode launched {launched} times, expected '
             f'n_layers x decode steps = {n_layers * decode_steps}')
    for fn in (da.decode_attention_kernel, da.paged_verify_attention_kernel):
        if fn.launches:
            fail(f'phase 13: {fn.__name__} launched {fn.launches} times')
    return out


# -------------------------------------------------------------- phase 15


# A prompt of 7 full blocks of 128 and a 104-token tail: at chunk 256 the
# prefill replica pushes 2, 2, 2 and 1 blocks after its four chunks.
HANDOFF_PROMPT = 1000
HANDOFF_CHUNK = 256
HANDOFF_TOKENS = (HANDOFF_PROMPT // 128) * 128
# The explicit push budget of (a); (d) runs once at the default (2 s).
HANDOFF_PUSH_BUDGET = 60.0
PUSH_BUDGET_ENV = 'SKYTPU_HANDOFF_PUSH_BUDGET_SECONDS'


def handoff_post(port: int, body: dict, target) -> tuple:
    """POST /prefill_handoff (unary), naming ``target`` in the handoff
    header: (X-Skytpu-Handoff, the JSON reply, seconds)."""
    headers = {'Content-Type': 'application/json'}
    if target:
        headers['X-Skytpu-Handoff-Target'] = target
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/prefill_handoff',
        data=json.dumps({**body, 'stream': False}).encode(), headers=headers)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
        mode = resp.headers.get('X-Skytpu-Handoff')
    return mode, out, time.perf_counter() - t0


class HandoffReplica:
    """One paged llama3-8b replica of phase 15 on a local port, built the
    way a user starts one (``build_engine`` with ``prefix_peers`` and the
    chunk, ``ModelServer`` with the role)."""

    def __init__(self, ms_lib, params, kv, role, port=0, peers=None):
        self.engine = ms_lib.build_engine(
            MODEL, 8, MAX_LEN, step_chunk=4, device=DEVICE, params=params,
            paged=True, kv_int8=kv == 'int8', prefix_peers=peers,
            prefill_chunk=HANDOFF_CHUNK)
        self.server = ms_lib.ModelServer(self.engine, port,
                                         host='127.0.0.1', role=role)
        self.port = self.server.start()
        self.url = f'http://127.0.0.1:{self.port}'

    def steps(self) -> int:
        return self.engine.stats()['decode_steps']

    def handoff(self) -> dict:
        return get_json(self.port, '/slo')['handoff']


def handoff_phase(torch, ms_lib, da, params, card):
    """Phase 15: the disaggregated handoff at llama3-8b width between a
    prefill and a decode replica, bf16 and int8 K/V, beside a monolithic
    control; launch counts reset by the caller. Returns the printed
    numbers by K/V dtype."""
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    rng = random.Random(15)
    pushes = []
    real_push = ms_lib.prefix_transfer.http_push

    def timed_push(peer, tokens, payload, budget_seconds, instance=None):
        # The transport as the server calls it, timed: raw bytes and the
        # seconds of one push (serialising, the wire, the peer's install).
        t0 = time.perf_counter()
        ok = real_push(peer, tokens, payload, budget_seconds, instance)
        pushes.append({'blocks': (payload['matched_tokens'] -
                                  payload['from_tokens']) // 128,
                       'raw_bytes': sum(a.nbytes for a in
                                        payload['arrays'].values()),
                       'seconds': time.perf_counter() - t0, 'ok': ok})
        return ok

    ms_lib.prefix_transfer.http_push = timed_push
    n_layers = cfg.n_layers
    decode_steps = 0
    out = {}
    try:
        for kv in ('bf16', 'int8'):
            replicas = []
            try:
                d_port = free_port()
                d_url = f'http://127.0.0.1:{d_port}'
                pre = HandoffReplica(ms_lib, params, kv, 'prefill',
                                     peers=[d_url])
                replicas.append(pre)
                dec = HandoffReplica(ms_lib, params, kv, 'decode', d_port,
                                     peers=[pre.url])
                replicas.append(dec)
                ctl = HandoffReplica(ms_lib, params, kv, 'mixed')
                replicas.append(ctl)
                prompt = rand_prompt(rng, cfg.vocab_size, HANDOFF_PROMPT)
                body = {'prompt': prompt, 'max_new_tokens': N_NEW}
                # The control: the prompt cold (a monolithic replica's
                # TTFT), then again over its own cached prefix, which is
                # the decode replica's path (7 blocks from the radix cache,
                # the 104-token tail prefilled over them).
                cold, cold_ttft = timed_stream(ctl.port, body,
                                               f'p15-{kv}-cold')
                want, warm_ttft = timed_stream(ctl.port, body,
                                               f'p15-{kv}-warm')
                # (a) the handoff under an explicit budget.
                os.environ[PUSH_BUDGET_ENV] = str(HANDOFF_PUSH_BUDGET)
                del pushes[:]
                steps0, h0, d0 = pre.steps(), pre.handoff(), dec.handoff()
                try:
                    mode, reply, leg_s = handoff_post(pre.port, body, d_url)
                finally:
                    os.environ.pop(PUSH_BUDGET_ENV, None)
                if mode != 'complete' or reply.get('handoff') != 'complete':
                    fail(f'{kv}: /prefill_handoff answered {mode} {reply}')
                h1, d1 = pre.handoff(), dec.handoff()
                pushed = h1['tokens_pushed'] - h0['tokens_pushed']
                injected = d1['tokens_injected'] - d0['tokens_injected']
                if pre.steps() != steps0:
                    fail(f'{kv}: the prefill replica ran '
                         f'{pre.steps() - steps0} decode steps')
                if not pushed == injected == HANDOFF_TOKENS:
                    fail(f'{kv}: pushed {pushed}, injected {injected}, '
                         f'expected {HANDOFF_TOKENS}')
                if [p['blocks'] for p in pushes] != [2, 2, 2, 1]:
                    fail(f'{kv}: pushes {pushes}')
                push_log = list(pushes)
                # (b) the decode leg, its launches counted alone.
                saved0 = get_json(dec.port, '/slo')['cache'][
                    'prefill_tokens_saved']
                launched0 = da.paged_decode_attention_kernel.launches
                dsteps0 = dec.steps()
                got, dec_ttft = timed_stream(dec.port, body,
                                             f'p15-{kv}-decode')
                dec_launches = (da.paged_decode_attention_kernel.launches
                                - launched0)
                dec_steps = dec.steps() - dsteps0
                if dec_launches != n_layers * dec_steps or not dec_steps:
                    fail(f'{kv}: the decode replica launched the paged '
                         f'decode kernel {dec_launches} times in '
                         f'{dec_steps} steps')
                saved = get_json(dec.port, '/slo')['cache'][
                    'prefill_tokens_saved'] - saved0
                if saved < HANDOFF_TOKENS:
                    fail(f'{kv}: the decode replica saved {saved} tokens')
                if got != want:
                    fail(f'{kv}: handed-off tokens {got[:8]}..., the '
                         f'control {want[:8]}...')
                mine = dec.engine.export_prefix_blocks(
                    prompt[:HANDOFF_TOKENS], 0, 60.0)
                theirs = ctl.engine.export_prefix_blocks(
                    prompt[:HANDOFF_TOKENS], 0, 60.0)
                if (mine is None or theirs is None or
                        mine['matched_tokens'] != HANDOFF_TOKENS or
                        theirs['matched_tokens'] != HANDOFF_TOKENS):
                    fail(f'{kv}: the prefix is not held whole by both')
                for name, t in theirs['arrays'].items():
                    if not torch.equal(mine['arrays'][name], t):
                        fail(f'{kv}: injected {name} differs from the '
                             f'control\'s')
                del mine, theirs
                # (d) the default budget, once: its outcome is printed,
                # and either way the request is answered in full.
                default = None
                if kv == 'bf16':
                    del pushes[:]
                    dbody = {'prompt': rand_prompt(rng, cfg.vocab_size,
                                                   HANDOFF_PROMPT),
                             'max_new_tokens': N_NEW}
                    mode, reply, dleg = handoff_post(pre.port, dbody, d_url)
                    if mode == 'complete':
                        toks, _ = timed_stream(dec.port, dbody,
                                               f'p15-{kv}-default')
                    else:
                        toks = reply.get('tokens', [])
                    if len(toks) != N_NEW:
                        fail(f'default budget: {mode} with {len(toks)} '
                             'tokens')
                    default = {'outcome': mode, 'leg_s': dleg,
                               'push_s': [round(p['seconds'], 3)
                                          for p in pushes]}
                    # A degrade backs the decode peer off; (c) needs it
                    # back.
                    pre.engine._peer_backoff_until.clear()  # pylint: disable=protected-access
                # (c) degrades: an untrusted target, then the decode
                # replica dying mid-handoff.
                degraded = {}
                for case, target in (('untrusted', 'http://127.0.0.1:1'),
                                     ('decode_death', d_url)):
                    cbody = {'prompt': rand_prompt(rng, cfg.vocab_size,
                                                   HANDOFF_PROMPT),
                             'max_new_tokens': N_NEW}
                    if case == 'decode_death':
                        os.environ['SKYTPU_CHAOS'] = 'handoff_decode_death'
                    try:
                        mode, reply, cs = handoff_post(pre.port, cbody,
                                                       target)
                    finally:
                        os.environ.pop('SKYTPU_CHAOS', None)
                    if (mode != 'degraded' or
                            len(reply.get('tokens', [])) != N_NEW):
                        fail(f'{kv} {case}: {mode}, '
                             f'{len(reply.get("tokens", []))} tokens')
                    degraded[case] = round(cs, 3)
                if not pre.engine.peer_in_backoff(d_url):
                    fail(f'{kv}: the dead decode peer is not in backoff')
                for r in (pre, dec, ctl):
                    decode_steps += r.steps()
                replicas = []
                for r in (pre, dec, ctl):
                    r.server.stop()
            finally:
                for r in replicas:
                    r.server.stop()
            out[kv] = {
                'prefill_leg_s': round(leg_s, 3),
                'pushes': [{'blocks': p['blocks'],
                            'raw_bytes': p['raw_bytes'],
                            'seconds': round(p['seconds'], 3)}
                           for p in push_log],
                'decode_ttft_s': round(dec_ttft, 3),
                'control_cold_ttft_s': round(cold_ttft, 3),
                'control_warm_ttft_s': round(warm_ttft, 3),
                'cold_tokens_equal': cold == want,
                'decode_launches': dec_launches, 'decode_steps': dec_steps,
                'degraded_s': degraded,
            }
            if default is not None:
                out[kv]['default_budget'] = default
            print(f'[handoff] {kv}: prefill leg {leg_s:.3f}s for '
                  f'{HANDOFF_PROMPT} tokens, pushes (blocks, raw bytes, s) '
                  f'{[(p["blocks"], p["raw_bytes"], round(p["seconds"], 3)) for p in push_log]}; '
                  f'decode TTFT {dec_ttft:.3f}s against the control\'s '
                  f'{cold_ttft:.3f}s cold and {warm_ttft:.3f}s over its '
                  f'own cache; default budget {default}; degraded legs '
                  f'{degraded}; on {card}', flush=True)
            del replicas
            gc.collect()
            empty_cache(torch)
    finally:
        ms_lib.prefix_transfer.http_push = real_push
    launched = da.paged_decode_attention_kernel.launches
    if launched != n_layers * decode_steps or not decode_steps:
        fail(f'phase 15: paged decode launched {launched} times, expected '
             f'n_layers x decode steps = {n_layers * decode_steps}')
    for fn in (da.decode_attention_kernel, da.paged_verify_attention_kernel):
        if fn.launches:
            fail(f'phase 15: {fn.__name__} launched {fn.launches} times')
    return out


# --------------------------------------------------------------- phase 6


def flash_bounds(b, s, h, hkv, d, causal, elem_bytes, peak_flops):
    """Least time per flash kernel, (ms, what sets it, flops): max(bytes
    each input read once and each output written once / HBM rate,
    operations this mask needs / peak rate). One product over the live
    (query, key) pairs is 2·d flops per pair: forward 2 products, dq 3,
    dk/dv 4."""
    pairs = s * (s + 1) // 2 if causal else s * s
    mac = b * h * d * pairs
    q_bytes = b * s * h * d * elem_bytes
    kv_bytes = b * s * hkv * d * elem_bytes
    row_bytes = b * h * s * 4                    # one fp32 [B,H,S] vector
    work = {'flash_forward_kernel': (2 * q_bytes + 2 * kv_bytes + row_bytes,
                                     4 * mac),
            'flash_bwd_dq_kernel': (3 * q_bytes + 2 * kv_bytes +
                                    2 * row_bytes, 6 * mac),
            'flash_bwd_dkv_kernel': (2 * q_bytes + 4 * kv_bytes +
                                     2 * row_bytes, 8 * mac)}
    bounds = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak_flops * 1e3
        bounds[name] = (max(t_bytes, t_ops),
                        'bytes' if t_bytes >= t_ops else 'operations', flops)
    return bounds


def row_scale(want):
    """Per row (the last axis, D): its rms, plus 1e-2 of the tensor's
    rms for rows that are ~0 (causal dq of query 0: dS = 0)."""
    return (want.square().mean(-1, keepdim=True).sqrt() +
            1e-2 * want.square().mean().sqrt())


def twin_error(got, want, dtype_name):
    """(None or why it fails, a report line) for a kernel's output
    against its plain twin under FLASH_FP32_REL_TOL / FLASH_BF16_TOL."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_err = diff.max().item()
    scale = want.abs().max().item()
    if dtype_name == 'fp32':
        bound = FLASH_FP32_REL_TOL * scale
        return (None if max_err <= bound else
                f'max abs err {max_err} > {bound}'), (
                    f'max_abs_err={max_err:.3e} (tol {bound:.3e} = '
                    f'{FLASH_FP32_REL_TOL} x max|twin|)')
    tol = FLASH_BF16_TOL
    fro = (diff.norm() / want.norm()).item()
    # The least atol, in units of the element's row scale, that every
    # element needs.
    atol = ((diff - tol['rtol'] * want.abs()) /
            row_scale(want)).max().item()
    msg = (f'max_abs_err={max_err:.3e} max|twin|={scale:.3f}; per element '
           f'needs atol {atol:.3e} x row scale at rtol {tol["rtol"]:.4g} '
           f'(tol {tol["atol"]}); ||d||/||twin|| {fro:.3e} (tol '
           f'{tol["fro"]})')
    if not atol <= tol['atol']:
        return 'an element is off by more than the per-element bound', msg
    if not fro <= tol['fro']:
        return f'relative Frobenius error {fro} > {tol["fro"]}', msg
    return None, msg


def flash_kernel_phase(torch, fa):
    """Kernels 4-6 against their plain twins: the training shapes (bf16
    and fp32), an S that does not tile, a small non-causal case. Times,
    bounds and the SDPA yardstick at the training shapes. Returns
    per-kernel rows for the kernels line."""
    import torch.nn.functional as F
    dev = torch.device('cuda')
    rows = {fn.__name__: {} for fn in fa.KERNELS}
    for label, (b, s, h, hkv, d, causal) in FLASH_CASES.items():
        for dtype_name, dtype in (('bf16', torch.bfloat16),
                                  ('fp32', torch.float32)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(11)
            q, k, v, g = (torch.randn(shape, generator=gen,
                                      device=dev).to(dtype)
                          for shape in ((b, s, h, d), (b, s, hkv, d),
                                        (b, s, hkv, d), (b, s, h, d)))
            out, lse = fa.flash_forward_kernel(q, k, v, causal)
            dsum = fa.row_dot(g, out)
            dq = fa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum, causal)
            dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal)
            torch.cuda.synchronize()
            p_out, p_lse = fa.flash_forward_plain(q, k, v, causal)
            grads = fa.flash_backward_plain(q, k, v, out, lse, g, causal)
            checks = {'flash_forward_kernel': [('out', out, p_out)],
                      'flash_bwd_dq_kernel': [('dq', dq, grads[0])],
                      'flash_bwd_dkv_kernel': [('dk', dk, grads[1]),
                                               ('dv', dv, grads[2])]}
            if not (lse - p_lse).abs().max().item() <= 1e-4:
                fail(f'flash forward {label} {dtype_name}: LSE differs')
            errs = {}
            for name, pairs in checks.items():
                errs[name] = 0.0
                for what, got, want in pairs:
                    if got.shape != want.shape or got.dtype != dtype or (
                            not torch.isfinite(got).all()):
                        fail(f'{name} {label} {dtype_name}: bad output')
                    err, msg = twin_error(got, want, dtype_name)
                    print(f'[flash] {name} {label} {dtype_name} {what}: '
                          f'{msg}', flush=True)
                    if err is not None:
                        fail(f'{name} {label} {dtype_name} {what}: {err}')
                    errs[name] = max(errs[name], (got.float() - want.float())
                                     .abs().max().item())
            del p_out, p_lse, grads
            if label != 'train':
                continue
            kernel_ms = {
                'flash_forward_kernel': cuda_time_ms(
                    lambda: fa.flash_forward_kernel(q, k, v, causal)),
                'flash_bwd_dq_kernel': cuda_time_ms(
                    lambda: fa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum,
                                                   causal)),
                'flash_bwd_dkv_kernel': cuda_time_ms(
                    lambda: fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum,
                                                    causal))}
            fwd_plain = cuda_time_ms(
                lambda: fa.flash_forward_plain(q, k, v, causal), iters=3,
                warmup=1)
            bwd_plain = cuda_time_ms(
                lambda: fa.flash_backward_plain(q, k, v, out, lse, g,
                                                causal), iters=3, warmup=1)
            # Yardstick, never called by the port: SDPA on [B,H,S,D] with
            # grouped K/V, and its autograd backward (dq, dk, dv at once).
            sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(
                sq, sk, sv, is_causal=causal, enable_gqa=True)
            sg = g.transpose(1, 2)
            lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, is_causal=causal, enable_gqa=True))
            lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
                sdpa_out, (sq, sk, sv), sg, retain_graph=True))
            del sq, sk, sv, sdpa_out
            bounds = flash_bounds(b, s, h, hkv, d, causal,
                                  2 if dtype_name == 'bf16' else 4,
                                  PEAK_BF16_FLOPS if dtype_name == 'bf16'
                                  else PEAK_FP32_FLOPS)
            for name, ms in kernel_ms.items():
                fwd = name == 'flash_forward_kernel'
                bound_ms, bound_by, flops = bounds[name]
                tflops = flops / ms / 1e9
                row = dict(max_abs_err=errs[name], ms=ms,
                           plain_ms=fwd_plain if fwd else bwd_plain,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_fwd if fwd else lib_bwd,
                           tflops=tflops, bound_fraction=bound_ms / ms)
                print(f'[flash] {name} {label} {dtype_name}: ms={ms:.4f} '
                      f'({tflops:.1f} TFLOP/s, {bound_ms / ms:.3f} of the '
                      f'bound) plain_ms={row["plain_ms"]:.4f} library_ms='
                      f'{row["library_ms"]:.4f} bound_ms={bound_ms:.4f} '
                      f'({bound_by})', flush=True)
                rows[name][dtype_name] = row
            # The backward as the trainer runs it, against SDPA's.
            pair_ms = cuda_time_ms(lambda: (
                fa.flash_bwd_dq_kernel(q, k, v, g, lse, fa.row_dot(g, out),
                                       causal),
                fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal)))
            pair_bound = (bounds['flash_bwd_dq_kernel'][0] +
                          bounds['flash_bwd_dkv_kernel'][0])
            print(f'[flash] backward pair {label} {dtype_name} (row_dot, dq, '
                  f'dk/dv): ms={pair_ms:.4f} ({pair_ms / lib_bwd:.3f} of '
                  f'SDPA backward\'s {lib_bwd:.4f} ms; bound '
                  f'{pair_bound:.4f} ms, {pair_bound / pair_ms:.3f} of it)',
                  flush=True)
            del q, k, v, g, out, lse, dsum, dq, dk, dv
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 7


def train_config(llama, dtype=None, policy='full'):
    """bench-1b as bench.py trains it: flash attention, remat ``policy``
    ('full' unless phase 14 asks for another), ce_chunks 8 (the config's
    own)."""
    import dataclasses
    cfg = dataclasses.replace(llama.CONFIGS[TRAIN_MODEL],
                              flash_attention=True, remat=True,
                              remat_policy=policy)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if cfg.ce_chunks != 8:
        fail(f'{TRAIN_MODEL} must carry ce_chunks=8, has {cfg.ce_chunks}')
    return cfg


def device_time_by_kernel(torch, prof):
    """[(ms, name, count)] of device-side events, largest first (a CPU
    op's device time repeats its kernels' time, so only device events
    count)."""
    rows = [(evt.self_device_time_total / 1e3, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA and
            evt.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def train_phase(torch, llama, train, fa, card):
    """The port's trainer at bench-1b width and depth on one fixed batch:
    losses finite and falling, exact launch counts per step, tokens/s,
    MFU, peak memory and the step's device time by kernel; then a
    checkpointed train_loop cut and resumed. Returns the launch counts of
    the main-path steps."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    cfg = train_config(llama)
    tc = train.TrainConfig(warmup_steps=10)
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    state = train.init_train_state(cfg, tc, dev)
    step = train.make_train_step(cfg, tc)
    tokens, targets = train.synthetic_batch(cfg.vocab_size, TRAIN_B,
                                            TRAIN_S, 1, 0)
    sync(torch)
    print(f'[train] {TRAIN_MODEL} ({cfg.num_params() / 1e9:.2f}B params, '
          f'flash, remat {cfg.remat_policy}, ce_chunks {cfg.ce_chunks}, '
          f'batch {TRAIN_B} x seq {TRAIN_S}) init in '
          f'{time.perf_counter() - t0:.1f}s', flush=True)
    sync(torch)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    expect = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    losses, secs = [], []
    fa.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = [fn.launches for fn in fa.KERNELS]
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, targets)
        loss = float(metrics['loss'])
        sync(torch)
        secs.append(time.perf_counter() - t0)
        grew = [fn.launches - n for fn, n in zip(fa.KERNELS, before)]
        print(f'[train] step {i + 1}: loss={loss:.5f} grad_norm='
              f'{float(metrics["grad_norm"]):.4f} {secs[-1]:.3f}s '
              f'launches +{grew}', flush=True)
        if grew != expect:
            fail(f'step {i + 1}: flash kernels launched {grew}, expected '
                 f'{expect} (2 x n_layers forward with remat, n_layers '
                 'each backward)')
        losses.append(loss)
    counts = {fn.__name__: fn.launches for fn in fa.KERNELS}
    if not all(math.isfinite(x) for x in losses):
        fail(f'non-finite losses {losses}')
    if not losses[-1] < losses[0]:
        fail(f'loss did not fall on the fixed batch: {losses}')
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == 'cuda' else float('nan'))
    step_s = statistics.median(secs[1:])
    tok_s = TRAIN_B * TRAIN_S / step_s
    mfu = train.tokens_per_second_to_mfu(tok_s, cfg, TRAIN_S,
                                         PEAK_BF16_FLOPS)
    print(f'[train] {TRAIN_MODEL} step {step_s:.4f}s (median of steps '
          f'2-{TRAIN_STEPS}), {tok_s:.1f} tokens/s, MFU {mfu:.4f} '
          f'(vs 989 TFLOP/s bf16), peak memory {peak_gb:.2f} GB '
          f'(max_memory_allocated), on {card}', flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, targets)
        float(metrics['loss'])
        sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(torch, prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print('[train] the profiler recorded no device time', flush=True)
    else:
        groups = {'flash forward': 'flash_fwd_',
                  'flash dq': 'flash_bwd_dq_',
                  'flash dk/dv': 'flash_bwd_dkv_'}
        split = {g: sum(r[0] for r in rows if key in r[1])
                 for g, key in groups.items()}
        split['GEMMs'] = sum(r[0] for r in rows if any(
            key in r[1].lower() for key in ('gemm', 'nvjet', 'cutlass',
                                            'xmma')))
        split['other'] = busy - sum(split.values())
        print(f'[train] one step under torch.profiler: wall {wall_ms:.1f} '
              f'ms, device busy {busy:.1f} ms ({busy / wall_ms:.3f} of '
              f'wall), {sum(r[2] for r in rows)} kernels; ' + ', '.join(
                  f'{g} {ms:.1f} ms ({ms / busy:.3f})'
                  for g, ms in split.items()) + f'; on {card}', flush=True)
        for ms, key, count in rows[:8]:
            print(f'[train]   {ms:9.3f} ms  x{count:<5d} {key[:90]}',
                  flush=True)
    del state, metrics
    empty_cache(torch)

    # Cut and resume: the step after a restore equals the unbroken run's.
    ckpt_dir = CKPT_DIR
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    runs = {}
    for label, n, ckpt in (('unbroken', 3, None), ('cut', 2, ckpt_dir),
                           ('resumed', 3, ckpt_dir)):
        seen = runs[label] = {}
        t0 = time.perf_counter()
        end = train.train_loop(
            cfg, tc, n, TRAIN_B, TRAIN_S, checkpoint_dir=ckpt,
            save_every=2, log_every=0, device=dev,
            on_step=lambda i, m, seen=seen: seen.__setitem__(
                i, float(m['loss'])))
        del end
        empty_cache(torch)
        print(f'[train] train_loop {label}: losses {seen} in '
              f'{time.perf_counter() - t0:.1f}s', flush=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if sorted(runs['resumed']) != [3]:
        fail(f'the resumed run did not start at step 3: {runs}')
    want, got = runs['unbroken'][3], runs['resumed'][3]
    print(f'[train] resumed step-3 loss {got!r} vs unbroken {want!r} '
          f'(diff {got - want:.3e})', flush=True)
    if not abs(got - want) <= RESUME_REL_TOL * abs(want):
        fail(f'resumed loss {got} != unbroken {want}')
    return counts, dict(step_s=step_s, tokens_per_s=tok_s, mfu=mfu,
                        peak_gb=peak_gb)


# --------------------------------------------------------------- phase 8


def leaf_names(tree, prefix=''):
    """Dotted names of ``train.tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [name for key in sorted(tree)
                for name in leaf_names(tree[key], f'{prefix}{key}.')]
    return [prefix[:-1]]


def train_e2e_phase(torch, llama, train):
    """Kernel path against plain path on the training loss (bench-1b,
    batch 2): one set of bf16 params from a seed, run in bf16 and,
    upcast, in fp32, each through the flash kernels and their plain
    twins. fp32: kernel against plain directly. bf16: loss and grad norm
    against the plain bf16 path; each grad tensor's distance from the
    fp32 plain path must be at most TRAIN_BF16_GRAD_RATIO times the
    plain bf16 path's own distance from it (the kernels round P and dS
    to bf16, the twins do not; every other rounding is shared). Returns
    the worst numbers."""
    dev = torch.device(DEVICE)
    cfg16 = train_config(llama)
    tokens, targets = (torch.from_numpy(a).to(dev) for a in
                       train.synthetic_batch(cfg16.vocab_size, 2, TRAIN_S,
                                             5, 0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    params16 = llama.init_params(cfg16, gen, dev)
    params32 = train.tree_map(lambda p: p.float(), params16)
    names = leaf_names(params16)
    runs = {}
    for dtype_name, params in (('fp32', params32), ('bf16', params16)):
        cfg = train_config(llama, torch.float32 if dtype_name == 'fp32'
                           else None)
        leaves = train.tree_leaves(params)
        for impl in ('kernel', 'plain'):
            for p in leaves:
                p.requires_grad_(True)
            loss = llama.loss_fn(params, tokens, targets, cfg, impl)
            grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            runs[dtype_name, impl] = (loss.item(), grads, norm.item())
            for p in leaves:
                p.requires_grad_(False)
            del loss
        empty_cache(torch)

    def rel(a, b):
        return [((x - y).norm() / y.norm()).item() for x, y in zip(a, b)]

    worst = {}
    for dtype_name in ('fp32', 'bf16'):
        (kl, kg, kn), (pl, pg, pn) = (runs[dtype_name, 'kernel'],
                                      runs[dtype_name, 'plain'])
        tol = TRAIN_E2E_TOL[dtype_name]
        loss_rel = abs(kl - pl) / abs(pl)
        norm_rel = abs(kn - pn) / pn
        grad_rel = rel(kg, pg)
        i_max = max(range(len(names)), key=grad_rel.__getitem__)
        print(f'[train-e2e] {dtype_name}: loss kernel {kl:.6f} plain '
              f'{pl:.6f} (rel {loss_rel:.3e}, tol {tol["loss"]}); grad norm'
              f' {kn:.5f} vs {pn:.5f} (rel {norm_rel:.3e}, tol '
              f'{tol["grad_norm"]}); worst per-tensor ||dg||/||g|| kernel vs'
              f' plain {grad_rel[i_max]:.3e} ({names[i_max]}, tol '
              f'{tol.get("grad", "none: see below")})', flush=True)
        ok = loss_rel <= tol['loss'] and norm_rel <= tol['grad_norm']
        worst[dtype_name] = dict(loss=loss_rel, grad_norm=norm_rel,
                                 grad=grad_rel[i_max])
        if dtype_name == 'fp32':
            ok = ok and grad_rel[i_max] <= tol['grad']
        else:
            ref = runs['fp32', 'plain'][1]
            k_ref, p_ref = rel(kg, ref), rel(pg, ref)
            ratio = [a / b for a, b in zip(k_ref, p_ref)]
            for i in sorted(range(len(names)), key=lambda i: -ratio[i])[:4]:
                print(f'[train-e2e] bf16 {names[i]}: from fp32, kernel path '
                      f'{k_ref[i]:.3e}, plain path {p_ref[i]:.3e} (ratio '
                      f'{ratio[i]:.3f}, tol {TRAIN_BF16_GRAD_RATIO}); kernel '
                      f'vs plain {grad_rel[i]:.3e}', flush=True)
            ok = ok and max(ratio) <= TRAIN_BF16_GRAD_RATIO
            worst['bf16'].update(ratio=max(ratio), from_fp32=max(k_ref))
        if not ok:
            fail(f'training kernel path differs from the plain path in '
                 f'{dtype_name}')
    del runs, params16, params32
    empty_cache(torch)
    return worst


# -------------------------------------------------------------- phase 14


def saved_bytes_per_layer_token(torch, llama, cfg) -> int:
    """What a policy keeps per layer per token beyond 'full' (which keeps
    the block input): the outputs of llama.SAVED_GEMMS' weights, or the
    attention output for 'attn', in the model dtype."""
    elem = torch.finfo(cfg.dtype).bits // 8
    if cfg.remat_policy == 'attn':
        return elem * cfg.n_heads * cfg.head_dim
    shapes = llama.param_shapes(cfg)['layers']
    return elem * sum(shapes[name][-1]
                      for name in llama.SAVED_GEMMS.get(cfg.remat_policy,
                                                        ()))


def remat_phase(torch, llama, train, fa, card, peak):
    """(a) bench-1b as phase 7 trains it, once per remat policy, each
    from the same seed-0 state on one fixed batch: exact flash launches
    every step; every step's loss and grad norm, and the params after
    the last step, equal to 'full''s bit for bit (step 1 runs at
    learning rate 0, so its bf16 grad norm is the only reading of its
    backward; the params carry step 2's); peak memory rising full <
    attn < ffn1 < ffn < dots; each
    policy's step seconds, tokens/s, MFU and peak GB printed, and its
    peak over 'full''s against the bytes the reference's residual set
    predicts."""
    tc = train.TrainConfig(warmup_steps=10)
    dev = torch.device(DEVICE)
    tokens, targets = train.synthetic_batch(
        llama.CONFIGS[TRAIN_MODEL].vocab_size, TRAIN_B, TRAIN_S, 1, 0)
    runs = {}
    full_params = None
    for policy in llama.REMAT_POLICIES:
        cfg = train_config(llama, policy=policy)
        expect = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
        state = train.init_train_state(cfg, tc, dev)
        step = train.make_train_step(cfg, tc)
        sync(torch)
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        base = allocated(torch)
        losses, norms, secs = [], [], []
        for i in range(POLICY_STEPS):
            before = [fn.launches for fn in fa.KERNELS]
            sync(torch)
            t0 = time.perf_counter()
            state, metrics = step(state, tokens, targets)
            losses.append(float(metrics['loss']))
            norms.append(float(metrics['grad_norm']))
            sync(torch)
            secs.append(time.perf_counter() - t0)
            grew = [fn.launches - n for fn, n in zip(fa.KERNELS, before)]
            if grew != expect:
                fail(f'remat {policy!r} step {i + 1}: flash kernels '
                     f'launched {grew}, expected {expect}')
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if dev.type == 'cuda' else float('nan'))
        step_s = statistics.median(secs[1:])
        tok_s = TRAIN_B * TRAIN_S / step_s
        mfu = train.tokens_per_second_to_mfu(tok_s, cfg, TRAIN_S, peak)
        runs[policy] = dict(
            loss=losses, grad_norm=norms, step_s=step_s, tokens_per_s=tok_s,
            mfu=mfu, peak_gb=peak_gb,
            predicted_gb=saved_bytes_per_layer_token(torch, llama, cfg) *
            TRAIN_B * TRAIN_S * cfg.n_layers / 1e9)
        print(f'[remat] {policy}: losses {losses} grad norms {norms}; step '
              f'{step_s:.4f}s (median of steps 2-{POLICY_STEPS}; '
              f'{[round(x, 4) for x in secs]}), {tok_s:.1f} tokens/s, MFU '
              f'{mfu:.4f}, peak {peak_gb:.3f} GB (max_memory_allocated; '
              f'{base / 1e9:.3f} GB of params and Adam state before the '
              f'steps), launches {expect} a step, on {card}', flush=True)
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f'remat {policy!r}: non-finite losses or norms')
        # Host copies, so no policy's peak holds another's params.
        params = [p.cpu() for p in train.tree_leaves(state.params)]
        if full_params is None:
            full_params = params
        runs[policy]['params_equal'] = all(
            torch.equal(a, b) for a, b in zip(params, full_params))
        del state, metrics, step, params
        empty_cache(torch)
    full = runs['full']
    for policy, run in runs.items():
        steps_equal = (run['loss'] == full['loss'] and
                       run['grad_norm'] == full['grad_norm'])
        print(f'[remat] {policy}: losses and grad norms of every step '
              f'{"equal" if steps_equal else "DIFFER"} to full\'s, params '
              f'after step {POLICY_STEPS} '
              f'{"torch.equal" if run["params_equal"] else "DIFFER"}; peak '
              f'over full {run["peak_gb"] - full["peak_gb"]:.3f} GB, the '
              f'reference\'s residual set predicts '
              f'{run["predicted_gb"]:.3f} GB', flush=True)
        if not (steps_equal and run['params_equal']):
            fail(f'remat {policy!r} differs from full: losses {run["loss"]}'
                 f' vs {full["loss"]}, grad norms {run["grad_norm"]} vs '
                 f'{full["grad_norm"]}, params equal {run["params_equal"]}')
    if dev.type == 'cuda':
        order = [runs[p]['peak_gb'] for p in REMAT_MEMORY_ORDER]
        if order != sorted(order) or len(set(order)) != len(order):
            fail(f'peak memory is not ordered {REMAT_MEMORY_ORDER}: '
                 f'{order}')
    return {p: {k: r[k] for k in ('step_s', 'tokens_per_s', 'mfu',
                                  'peak_gb')} for p, r in runs.items()}


def telemetry_train_phase(torch, llama, train, metrics, runtime_metrics,
                          peak):
    """(b) train_loop for PROFILED_STEPS steps with SKYTPU_PROFILE_DIR a
    temporary directory and SKYTPU_PROFILE_STEPS=2: the registry counts
    every step, its MFU gauge is the MFU of its tokens/s gauge, the gauge
    agrees with the loop's own step times (read through on_step), and one
    capture is written whose trace names the flash forward kernel."""
    cfg = train_config(llama)
    prev = metrics.set_registry(metrics.MetricsRegistry())
    tmp = tempfile.mkdtemp(prefix='chip_smoke_profile_')
    env = {runtime_metrics.PROFILE_DIR_ENV: tmp,
           runtime_metrics.PROFILE_STEPS_ENV: '2'}
    saved_env = {k: os.environ.get(k) for k in
                 (*env, runtime_metrics.PEAK_FLOPS_ENV)}
    os.environ.update(env)
    os.environ.pop(runtime_metrics.PEAK_FLOPS_ENV, None)
    stamps = []
    try:
        t0 = time.perf_counter()
        end = train.train_loop(
            cfg, train.TrainConfig(warmup_steps=10), PROFILED_STEPS,
            TRAIN_B, TRAIN_S, log_every=0, device=torch.device(DEVICE),
            on_step=lambda i, m: stamps.append(time.perf_counter()))
        del end
        empty_cache(torch)
        wall = time.perf_counter() - t0
        reg = metrics.get_registry()
        steps = reg.get('skytpu_train_steps_total').value()
        hist = reg.get('skytpu_train_step_seconds')
        tps = reg.get('skytpu_train_tokens_per_second').value()
        mfu = reg.get('skytpu_train_mfu').value()
        captures = reg.get('skytpu_profile_captures_total')
        captures = captures.value() if captures else 0
        traces = sorted(glob.glob(os.path.join(tmp, 'train',
                                               '*.pt.trace.json')))
        trace_text = ''
        if traces:
            with open(traces[0]) as f:
                trace_text = f.read()
        loop_tps = TRAIN_B * TRAIN_S / (stamps[-1] - stamps[-2])
        want_mfu = train.tokens_per_second_to_mfu(tps, cfg, TRAIN_S, peak)
        print(f'[telemetry] train_loop {PROFILED_STEPS} steps in '
              f'{wall:.1f}s: skytpu_train_steps_total {steps}, step seconds'
              f' count {hist.count()} sum {hist.sum():.4f}, tokens/s gauge '
              f'{tps:.1f} (the loop\'s last step by on_step: '
              f'{loop_tps:.1f}), MFU gauge {mfu:.6f} (tokens_per_second_to_'
              f'mfu at {peak:.4g}: {want_mfu:.6f}), captures {captures}, '
              f'trace {[os.path.basename(t) for t in traces]} '
              f'({len(trace_text)} bytes, flash_fwd_ '
              f'{trace_text.count("flash_fwd_")} times)', flush=True)
    finally:
        metrics.set_registry(prev)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    if steps != PROFILED_STEPS or hist.count() != PROFILED_STEPS - 1:
        fail(f'telemetry counted {steps} steps ({hist.count()} timed) of '
             f'{PROFILED_STEPS}')
    if not (mfu > 0 and mfu == want_mfu):
        fail(f'skytpu_train_mfu {mfu} != tokens_per_second_to_mfu of its '
             f'tokens/s gauge {want_mfu}')
    if not abs(tps - loop_tps) <= 0.01 * loop_tps:
        fail(f'tokens/s gauge {tps} vs the loop\'s {loop_tps}')
    if captures != 1 or len(traces) != 1 or 'flash_fwd_' not in trace_text:
        fail(f'profile: {captures} captures, traces {traces}, flash_fwd_ '
             f'in the trace: {"flash_fwd_" in trace_text}')
    return dict(steps=steps, tokens_per_s=tps, mfu=mfu,
                trace_bytes=len(trace_text))


def resnet_phase(torch, resnet, card):
    """(c) ResNet-50 at 224 x 224 in bf16 (cuDNN convolutions, channels-
    last), RESNET_STEPS momentum-SGD steps on one fixed batch: finite,
    falling losses; examples/s and peak memory. Then the debug ResNet in
    fp32 on the card against the same port on the CPU (TF32 off)."""
    dev = torch.device(DEVICE)
    cfg = resnet.CONFIGS[RESNET_MODEL]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = resnet.init_params(cfg, gen, dev)
    momentum = resnet.zeros_momentum(params)
    step = resnet.make_train_step(cfg, lr=RESNET_LR)
    images = torch.randn((RESNET_B, RESNET_SIZE, RESNET_SIZE, 3),
                         generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (RESNET_B,), generator=gen,
                           device=dev)
    sync(torch)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(RESNET_STEPS):
        sync(torch)
        t0 = time.perf_counter()
        params, momentum, loss = step(params, momentum, images, labels)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == 'cuda' else float('nan'))
    ex_s = RESNET_B * (RESNET_STEPS - 1) / sum(secs[1:])
    print(f'[resnet] {RESNET_MODEL} {RESNET_SIZE}x{RESNET_SIZE} bf16 batch '
          f'{RESNET_B}, lr {RESNET_LR}: losses {[round(x, 4) for x in losses]}'
          f'; {ex_s:.1f} examples/s (steps 2-{RESNET_STEPS}; first step '
          f'{secs[0]:.2f}s), peak {peak_gb:.2f} GB (max_memory_allocated), '
          f'on {card}', flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f'ResNet losses not finite: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'ResNet loss did not fall on the fixed batch: {losses}')
    del params, momentum, step, images, labels
    empty_cache(torch)
    return dict(examples_per_s=ex_s, peak_gb=peak_gb, losses=losses,
                parity=resnet_parity(torch, resnet))


def resnet_parity(torch, resnet):
    """The debug ResNet in fp32 on DEVICE against the same port on the
    CPU: logits, loss, every grad and two SGD steps, held to
    tests/test_torch_resnet.py's rules (cuDNN against oneDNN: only the
    summation order differs, TF32 is off)."""
    import dataclasses
    cfg = dataclasses.replace(resnet.CONFIGS['debug'], dtype=torch.float32)
    params = resnet.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    images = torch.randn((4, 32, 32, 3), generator=gen)
    labels = torch.randint(0, cfg.num_classes, (4,), generator=gen)
    results = {}
    for dev in ('cpu', DEVICE):
        # A copy per device: the steps below update it in place.
        p = resnet.tree_map(lambda t, dev=dev: t.to(dev, copy=True), params)
        x, y = images.to(dev), labels.to(dev)
        logits = resnet.forward(p, x, cfg).cpu()
        leaves = resnet.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = resnet.loss_fn(p, x, y, cfg)
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        for t in leaves:
            t.requires_grad_(False)
        m = resnet.zeros_momentum(p)
        step = resnet.make_train_step(cfg)
        for _ in range(2):
            p, m, step_loss = step(p, m, x, y)
        results[dev] = (logits, loss.item(), grads, step_loss.item(),
                        [t.cpu() for t in resnet.tree_leaves(p)])
    (cl, closs, cg, cs, cp), (gl, gloss, gg, gs, gp) = (results['cpu'],
                                                       results[DEVICE])

    def worst(got, want):
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(got, want))

    err = dict(logits=worst([gl], [cl]),
               loss=abs(gloss - closs) / abs(closs),
               grads=worst(gg, cg), step_loss=abs(gs - cs) / abs(cs),
               params=worst(gp, cp))
    print(f'[resnet] debug fp32 {DEVICE} vs cpu: {err} (tolerances '
          f'{RESNET_PARITY_TOL})', flush=True)
    for key, value in err.items():
        if not value <= RESNET_PARITY_TOL[key]:
            fail(f'ResNet {DEVICE} vs cpu: {key} {value} > '
                 f'{RESNET_PARITY_TOL[key]}')
    return err


def trainers_phase(torch, llama, train, fa, card):
    """Phase 14: the remat policies, the trainer's telemetry and
    profiler, the ResNet trainer."""
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.observability import metrics
    from skypilot_tpu_torch.observability import runtime_metrics
    from skypilot_tpu_torch.utils import accelerator_registry
    peak = accelerator_registry.peak_bf16_flops(torch.device(DEVICE))
    if torch.device(DEVICE).type == 'cuda' and not peak:
        fail(f'no bf16 peak for {torch.cuda.get_device_name(0)!r} in '
             'utils/accelerator_registry')
    t0 = time.perf_counter()
    remat = remat_phase(torch, llama, train, fa, card, peak or 1.0)
    t1 = time.perf_counter()
    tele = telemetry_train_phase(torch, llama, train, metrics,
                                 runtime_metrics, peak or 1.0)
    t2 = time.perf_counter()
    res = resnet_phase(torch, resnet, card)
    print(f'[time] phase 14: remat {t1 - t0:.1f}s, telemetry {t2 - t1:.1f}s'
          f', resnet {time.perf_counter() - t2:.1f}s', flush=True)
    return dict(remat=remat, telemetry=tele,
                resnet={k: res[k] for k in ('examples_per_s', 'peak_gb')})


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; nothing to run.',
              file=sys.stderr)
        return 2
    try:
        from skypilot_tpu_torch.models import decode, llama, train
        from skypilot_tpu_torch.ops import cuda_build, quant
        from skypilot_tpu_torch.ops import decode_attention as da
        from skypilot_tpu_torch.ops import flash_attention as fa
        from skypilot_tpu_torch.serve import model_server as ms_lib
    except ImportError as e:
        print(f'chip_smoke: the skypilot_tpu_torch package is not beside '
              f'this script ({e}); run it from the root of a checkout.',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Every replica journals: keep the rows in a directory of this run,
    # not in ~/.skytpu (phase 11 gives each of its replicas a file).
    journal_dir = tempfile.mkdtemp(prefix='chip_smoke_journal_')
    atexit.register(shutil.rmtree, journal_dir, True)
    os.environ['SKYTPU_JOURNAL_PATH'] = os.path.join(journal_dir,
                                                     'journal.db')

    card = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f'[device] {name} | nvidia-smi: {card} | torch {torch.__version__}'
          f' cuda {torch.version.cuda}', flush=True)
    built = cuda_build.build()
    for lib, secs in built.items():
        print(f'[build] {lib}: {secs:.1f}s', flush=True)
        log = cuda_build.library_path(lib).with_suffix('.log')
        print(log.read_text(errors='replace').strip(), flush=True)
    wgmma_sass_check(cuda_build)
    hmma_sass_check(cuda_build)

    def phase_done(label):
        print(f'[time] {label} done at {time.perf_counter() - t_start:.1f}s',
              flush=True)

    rows = kernel_phase(torch, da, quant)
    params, counts, paged_batches, paged_results, dense_results = \
        main_path_phase(torch, ms_lib, da, card)
    worst = e2e_phase(torch, decode, llama, params)
    print(f'[e2e] worst max|dlogit| / max|logit|: {worst}', flush=True)
    phase5 = profile_phase(torch, decode, llama, params, card)
    phase_done('serving phases 2-5')

    # Phase 9 (speculative decoding) while the llama3-8b weights are up.
    verify_rows = verify_kernel_phase(torch, da, quant)
    spec_counts, spec_runs = spec_serve_phase(torch, ms_lib, da, params,
                                              paged_batches, card)
    spec_parity_phase(torch, ms_lib, decode, llama, params, paged_results,
                      spec_runs)
    spec_split = spec_profile_phase(torch, decode, llama, params, card)
    phase_done('phase 9')

    # Phase 10 (chunked prefill, supervision) while the weights are up.
    da.reset_launch_counts()
    chunked_phase(torch, ms_lib, da, decode, llama, params, paged_batches,
                  paged_results, card)
    hol = hol_phase(torch, ms_lib, params, card)
    supervised = supervision_phase(torch, ms_lib, da, params, paged_results,
                                   dense_results, card)
    drain_phase(torch, ms_lib, da, params, card)
    phase10_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 10] launches {phase10_counts}; head-of-line {hol}; '
          f'supervision {supervised}', flush=True)
    if not all(phase10_counts.values()):
        fail(f'a decode kernel was not launched in phase 10: '
             f'{phase10_counts}')
    phase_done('phase 10')

    # Phase 11 (serving telemetry) while the weights are up.
    da.reset_launch_counts()
    telemetry = telemetry_phase(torch, ms_lib, da, params, paged_batches,
                                card)
    phase11_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 11] launches {phase11_counts}; {telemetry}', flush=True)
    if not all(phase11_counts.values()):
        fail(f'a decode kernel was not launched in phase 11: '
             f'{phase11_counts}')
    phase_done('phase 11')

    # Phase 12 (int8 weights, checkpoint restore) while the weights are up.
    da.reset_launch_counts()
    int8_report = int8_phase(torch, ms_lib, quant, da, decode, llama, train,
                             params, dense_results, paged_batches, phase5,
                             card)
    phase12_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 12] launches {phase12_counts}; {int8_report}',
          flush=True)
    if not all(phase12_counts.values()):
        fail(f'a decode kernel was not launched in phase 12: '
             f'{phase12_counts}')
    phase_done('phase 12')

    # Phase 13 (the cross-replica prefix fetch) while the weights are up.
    da.reset_launch_counts()
    prefix_report = prefix_fetch_phase(torch, ms_lib, da, params, card)
    phase13_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 13] launches {phase13_counts}; {prefix_report}',
          flush=True)
    phase_done('phase 13')

    # Phase 15 (the disaggregated handoff) while the weights are up.
    da.reset_launch_counts()
    handoff_report = handoff_phase(torch, ms_lib, da, params, card)
    phase15_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 15] launches {phase15_counts}; {handoff_report}',
          flush=True)
    del params, spec_runs, paged_results, dense_results
    torch.cuda.empty_cache()
    phase_done('phase 15')

    flash_rows = flash_kernel_phase(torch, fa)
    phase_done('phase 6')
    train_counts, train_stats = train_phase(torch, llama, train, fa, card)
    phase_done('phase 7')
    train_worst = train_e2e_phase(torch, llama, train)
    print(f'[train-e2e] worst relative differences: {train_worst}',
          flush=True)
    phase_done('phase 8')
    fa.reset_launch_counts()
    trainers = trainers_phase(torch, llama, train, fa, card)
    phase14_counts = {fn.__name__: fn.launches for fn in fa.KERNELS}
    print(f'[phase 14] launches {phase14_counts}; {trainers}', flush=True)
    if not all(phase14_counts.values()):
        fail(f'a flash kernel was not launched in phase 14: '
             f'{phase14_counts}')
    phase_done('phase 14')

    kernels = []
    for kname, row in rows.items():
        main = row['bf16']
        kernels.append({
            'name': kname, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': DECODE_SOURCES[kname], 'launches': counts[kname],
            'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
            'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
            'bound_by': main['bound_by'],
            'library_ms': main['library_ms'], 'int8': row['int8'],
            'phase10_launches': phase10_counts[kname],
            'phase11_launches': phase11_counts[kname],
            'phase12_launches': phase12_counts[kname],
            'phase13_launches': phase13_counts[kname],
            'phase15_launches': phase15_counts[kname]})
    kernels.append({
        'name': 'paged_verify_attention_kernel', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
        'replaces': VERIFY_SOURCE,
        'launches': spec_counts['paged_verify_attention_kernel'],
        'max_abs_err': verify_rows['bf16']['max_abs_err'],
        'ms': verify_rows['bf16']['ms'],
        'plain_ms': verify_rows['bf16']['plain_ms'],
        'bound_ms': verify_rows['bf16']['bound_ms'],
        'bound_by': verify_rows['bf16']['bound_by'],
        'library_ms': verify_rows['bf16']['library_ms'],
        'int8': verify_rows['int8'], 'spec_round': spec_split,
        'phase10_launches':
            phase10_counts['paged_verify_attention_kernel'],
        'phase11_launches':
            phase11_counts['paged_verify_attention_kernel'],
        'phase12_launches':
            phase12_counts['paged_verify_attention_kernel'],
        'phase13_launches':
            phase13_counts['paged_verify_attention_kernel'],
        'phase15_launches':
            phase15_counts['paged_verify_attention_kernel']})
    for kname, row in flash_rows.items():
        main = row['bf16']
        kernels.append({
            'name': kname, 'route': 'cuda',
            'source': FLASH_FILES[kname],
            'replaces': FLASH_SOURCES[kname],
            'launches': train_counts[kname],
            'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
            'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
            'bound_by': main['bound_by'],
            'library_ms': main['library_ms'], 'fp32': row['fp32'],
            'phase14_launches': phase14_counts[kname]})
    print(f'[done] {time.perf_counter() - t_start:.1f}s total; train '
          f'{train_stats}; trainers {trainers}', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
