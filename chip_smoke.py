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
   the card's name and power limit. Then ``train.train_loop`` at the
   same width cut to ``RESUME_LAYERS`` (4) layers with a checkpoint
   directory, cut after step 2 and resumed: the resumed step-3 loss
   must equal the unbroken run's.
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
   full depth's reading printed. (d) At full width cut to
   ``RESTORE_LAYERS`` (4) layers: the seed-0 bf16 params saved with
   ``checkpoint.save_params`` (5 GB free needed under ``build/``); a
   replica built the CLI's way (``checkpoint_dir``, ``int8=True``, no
   params, seed 1) logs the restored step and gives the tokens of an
   in-memory dense int8 replica of the same params on (b)'s prompts,
   the same build without ``checkpoint_dir`` gives others, and a
   trainer checkpoint raises ValueError.

13. The cross-replica prefix fetch, run after phase 12 while the
   llama3-8b weights are loaded, at their full width cut to their first
   ``PREFIX_LAYERS`` (4) layers; the launch counts are reset just
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
   from the seed-0 state, 2 steps on one fixed batch: the flash kernels
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
   the llama3-8b weights are loaded, cut to their first
   ``HANDOFF_LAYERS`` (4) layers; the launch counts are reset just
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

16. The durable block store, run after phase 15 while the llama3-8b
   weights are loaded, cut to their first ``STORE_LAYERS`` (4) layers;
   the launch counts are reset just before and read
   just after. For bf16 and then int8 K/V, phase 13's replicas and
   prompts (a 1,024-token prefix, tails of 16-40 tokens, 32 new tokens),
   built with ``store_url`` and the store's fetch and spill budgets at
   60 s (``SKYTPU_STORE_FETCH_BUDGET_SECONDS``,
   ``SKYTPU_STORE_SPILL_BUDGET_SECONDS``), beside a ``--role store``
   server over a temporary directory (``SKYTPU_STORE_DIR``). (a) The
   owner's write-behind spill persists its 8 blocks; the store counts
   one entry. (b) The owner is stopped; a fresh replica without peers
   answers the four prompts over the store's blocks: tokens equal the
   owner's own answers over its cache (the same path), one fetch hit of
   1,024 tokens, the blocks ``torch.equal`` to the owner's, and the
   paged-decode kernel launched exactly n_layers x its decode steps.
   (c) A new store server over the same directory holds the entry and
   serves the same fetch to another fresh replica. (d) ``POST /prewarm``
   with the prefix's family digest warms a fresh replica: its next
   request is a radix hit with the control's tokens and no store fetch.
   (e) ``SKYTPU_CHAOS=store_down``: the request is answered by plain
   prefill on the card with a storeless replica's tokens, and the store
   is backed off; ``store_torn_entry``: a 4-block spill the writer
   believes landed reads back as a miss (one ``torn_dropped``), the
   reader's tokens its own prefill's. (f) Once, in bf16, the default
   budgets (2 s spill, 0.5 s fetch): outcomes printed, the requests
   answered in full either way. Over the phase the paged-decode kernel
   ran n_layers x every replica's steps, the dense and verify kernels
   never. Printed: each spill's blocks, raw bytes and seconds, the
   entry's bytes on disk, the store's stats, the fetch's seconds from
   its journal row, and first-token times store-warmed, prewarmed and
   cold.

17. The compiled rounds, run after phase 16 while the llama3-8b weights
   are loaded; the launch counts are reset just before and read just
   after. Every engine of the earlier phases already runs its decode
   rounds, spec steps and paged prefills as CUDA-graph replays (the
   engine's default on the card); this phase holds them to the eager
   path (``rounds='eager'``). (a) Phase 3's requests through a graph
   and an eager replica, at full width cut to ``GRAPH_SERVE_LAYERS`` (4)
   layers, each of dense bf16, paged bf16, paged int8 K/V,
   paged int8 weights, spec (spec_k 4, drafter depth 1) and paged with
   prefill_chunk 256 (phase 10's mix): tokens identical request by
   request, each replica's launches exact as in phases 3, 9 and 12, the
   graph replica capturing each of its keys once and replaying the
   rest, the eager one capturing nothing, the chunks as phase 10
   predicts; captures by kind, their seconds and the graph pool's bytes
   printed. (b) The paged bf16 decode round (8 lanes at phase 5's
   lengths, step_chunk 4) and (c) the spec round, graph against eager:
   host ms a round and a decode step (windows in turns), then the
   device's busy share, kernels and graph launches a round under
   torch.profiler, exactly one graph launch a round on the graph path.
   (d) The host ms a 256-token chunk of a 1,920-token prompt adds to a
   round of 7 decoding lanes, both paths. The phase's seconds printed.

18. The TP replica, run after phase 17 while the llama3-8b weights are
   loaded; the launch counts are reset just before and read just after.
   (a) Kernels 2-3 against their twins at a rank's shard shape (H 16,
   Hkv 4, hd 128, block_k 128), bf16 and int8 K/V, verify at S 5. (b)
   llama3-8b at full width cut to its first ``TP_LAYERS`` (4) layers
   served at tp=2 with both ranks on the one card
   (``parallel/tp.local_group`` over two ``cuda:0`` ranks, gloo, whose
   collectives copy through host tensors, and eager rounds:
   the CLI's ``--tp`` takes a card a rank over NCCL, which one card
   cannot show), built through ``build_engine`` and the ModelServer,
   each case beside an eager tp=1 control on phase 3's paged requests cut
   to 8 new tokens: bf16 and int8 K/V, spec_k 4 at drafter depth 1,
   prefill_chunk 256 and int8 weights. The numeric check: the first-token logits of three fresh
   prompts (24, 300 and 1,100 tokens; the last position of each
   prefill) within 0.09 of the largest logit of the control's, bf16
   weights (sound readings 0.052-0.060, one all-reduce left out
   >= 0.13), and bit-equal with int8 weights. Tokens equal the
   control's request by request, a difference allowed only at a
   near-tie of the control's logits (phase 9's rule, printed; random
   llama3-8b logits sit a few ulps apart, so this rule alone would pass
   nearly anything in bf16); every rank's pool is [32, n_blocks, 128,
   4, 128]; each rank launched the case's kernel n_layers x the decode steps and the
   worker every kernel as often as rank 0; per-rank peak memory printed.
   The same cases but int8 weights in fp32 at 2 layers, where the TP
   sums round in fp32: 32 tokens a request, equal in every request.
   (c) In bf16, the tp=2 replica's export of the shared 256-token prefix
   against the control's: the same fields, planes, shapes and dtypes,
   layer 0 bit-equal; a fresh tp=1 engine installs it and continues as
   the control did. (d) On the bf16 case's two replicas, the host ms of
   an eager decode round (8 lanes, step_chunk 4), tp=2 against tp=1
   (printed as what it is: gloo through the host on one shared card). (e) A one-rank NCCL group captures its all_reduce
   and all_gather in a CUDA graph and replays them over new inputs.

19. The sharded trainer, run after phase 14. (a) Kernels 4-6 against
   their twins at a rank's shard shape (B 2, S 2048, H 8, Hkv 4, D 128),
   bf16 and fp32, under phase 6's ``twin_error``. The flash launch
   counts are then reset, and read after (b)-(c). (b) bench-1b at full
   width and depth (flash, remat 'full', ce_chunks 8, seq 2048) trained
   by the port's sharded trainer on a (data 1, fsdp 2, model 2) mesh of
   four ranks sharing the one card (``parallel/distributed.local_ranks``
   over four ``cuda:0`` ranks, gloo, whose collectives copy through
   host tensors: the CLI's default, NCCL with a card a rank, needs four
   cards), a global batch of 4, 3 steps from the seed-0 state (each rank
   drawing leaf by leaf), against a one-rank control (the unsharded
   ``make_train_step`` on the same state and batches): each step's loss
   and grad norm and the params after 3 steps (gathered; their distance
   from the control's over the control's own update) within
   ``SHARD_TOL``, the step-1 loss within the reference's rtol 5e-3, and
   every rank launching the flash forward exactly 2L times a step and
   dq, dk/dv L times; per-rank peak memory and step seconds printed.
   (b') The same under remat 'dots' for 2 steps: within ``SHARD_TOL``
   of the control and bit-equal to (b)'s first 2 losses and grad norms;
   on every rank the bytes one block's backward keeps (its inputs
   through ``saved_tensors_hooks``, the kept GEMM outputs as the
   storages its ops made that outlive it) within 5% of the arithmetic at
   the rank's shard widths, no gathered weight kept.
   (c) The same as (b) at 2 layers in fp32: losses and grad norms within
   2e-5 of the control's; (c') 'ffn' and 'ffn1' there, 1 step,
   bit-equal to (c). (d) (b)'s ranks save a checkpoint at step 2 in the
   sharded format (each rank its own slices, a replicated one once):
   each rank's bytes on disk, their sum against the state's bytes and
   the save's seconds printed; a one-rank ``train_loop`` resumes it, and
   its step 3 matches (b)'s step 3 within (b)'s loss bound. (e)
   ResNet-50 (phase 14's 224 x 224, bf16, batch 128, learning rate)
   data parallel over two of (b)'s four ranks (a mesh over ranks 0-1;
   sync BN), 2 steps, against a one-rank control on the same batch:
   losses within ``RESNET_DP_TOL``.
20. Mixture of experts, GPipe and ring attention, run after phase 19.
   The flash launch counts are reset before (a)'s one-rank steps and
   read after the ranks' run, before the kernel-against-plain checks.
   (a) mixtral-8x7b at its full width cut to 2 layers (bf16, flash,
   remat, batch 2 x 2048): on the seed-0 params the kernel path's loss,
   with the plain pass's top-k choices fed back in, against the plain
   path's, and the kernel step's step-1 loss against the kernel path's,
   each within ``MOE_PLAIN_LOSS_TOL`` (phase 8's bf16 bound; the tokens
   whose experts differ when each routes on its own printed), 2 Adam
   steps with the flash kernels launched 2L, L, L a step; then over an
   (expert 2, model 2) mesh of four ranks sharing the card over gloo (4
   experts a rank, each expert's ffn dim split in two), the same 2
   steps within ``SHARD_TOL['bf16']`` of the one-rank losses and grad
   norms, and step 1's loss and grad norm (no update) with the 'model'
   part of the experts' sum left out, which must break that bound;
   per-rank peak memory printed; fp32 at 1 layer, logits and aux of the kernel
   path against the plain path within 2e-5. (b) GPipe: bench-1b at full
   width and depth, 4 microbatches of 1 x 2048, over (stage 2) and
   (stage 4) on the card, 2 steps, losses and grad norms within
   ``SHARD_TOL['bf16']`` of a one-rank ``make_train_step`` on the same
   batch, fp32 at 4 layers over (stage 2) within 2e-5; every stage
   launches the flash forward 2·(L/S)·M times a step and dq, dk/dv
   (L/S)·M times (bubble ticks are skipped, not run on zeros). (c) Ring
   attention at llama3-8b's widths (H 32, Hkv 8, D 128), B 1, S 8192,
   over a seq axis of 4 ranks: output and dq/dk/dv against the plain
   twin on the whole sequence, fp32 under ``twin_error``'s bound; bf16
   the ring and the flash kernel on the same inputs under twin_error's
   rule with the per-element atols of ``RING_ATOL`` (dq's first
   ``RING_LEAD_ROWS`` query rows apart: the reference's algorithm keeps
   P's rounding in rows whose dq nearly cancels), and the ring against
   the kernel within twice the twin's norm bound. Kernels 4-6 against
   their twins at (a)'s attention shape ``MOE_FLASH_CASE`` (a GQA group
   of 4) under twin_error's bounds. Each case's seconds and
   per-rank peak memory are printed with the card's line.
21. The compiled static generate and dense insert, run after phase 18
   while the llama3-8b weights are loaded; the launch counts are reset
   just before and read just after. (a) ``decode.generate`` as the
   reference's decode bench runs it (bench.py's decode payloads): batch
   32, a 128-token prompt, 128 new tokens, max_len 256, greedy, at full
   width and depth, under bf16, int8 weights and int8 K/V: one eager
   call (``rounds='eager'``), the call that captures the
   ``decode.GenerateProgram``'s graphs and two replayed calls, tokens
   identical, the dense decode kernel launched n_layers x 127 times by
   every call, 9 graph launches a replayed call; printed: seconds a
   call both ways, the capture's, the prefill alone and decode tokens/s
   as decode_bench computes them (completed tokens / (generate -
   prefill)). (b) The dense replica's insert (``('prefill', bucket)``,
   the reference's ``_prefill_greedy_impl``) at full depth, a graph and
   an eager engine given the same requests in turns, three prompt
   lengths at each of buckets 128, 512 and 2048 in two lanes: first
   tokens and the lane's K/V bit-equal, one capture a bucket, TTFT on
   the host clock. The phase's seconds printed.

Every replica journals into a temporary directory of the run, not into
``~/.skytpu``. Before phase 13 the whole run took 273.7 s on an H100
(700 W), phase 12 88.9 s of it (its int8 step profile 36.9 s, the 16 GB
save and restore 31.3 s), well inside its time limit, so every phase
runs at full depth; ``PERF.md`` has the whole run's time with the later
phases.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""
import atexit
import contextlib
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
# Phases 13, 15, 16 and 18 serve MODEL at its full width cut in depth
# (``served_depth``; each phase's constant names its cut): their checks
# hold tokens, blocks and logits against controls at the same depth and
# count the kernels' launches per layer, so they run whole at any depth,
# and the JSON wire work and the TP replicas' host copies that dominate
# them scale with the layers. Cut to keep the whole run under 900 s of
# its 1,200 s time limit once phase 19's selective-remat runs and phase
# 20's model axis were added (a host 1.4x slower on the host-bound phases
# cut an earlier run at 1,260 s).
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
# The checkpointed train_loop cut and resumed at bench-1b's width cut to
# this depth: 16 (the model's) before phase 19's sharded runs were
# added; cut to keep the run inside its time limit (phase 19 (d) saves
# and resumes the whole bench-1b state).
RESUME_LAYERS = 4
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
# 3 before phase 19 was added; cut to keep the run inside its limit.
POLICY_STEPS = 2
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
# holds the stream while device_ms enqueues its calls; a window the host
# outran is measured again under a spin twice as long, up to
# SPIN_ATTEMPTS times (a slow host once took 31 ms to enqueue).
SPIN_CYCLES = 50_000_000
SPIN_ATTEMPTS = 3


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call on the card alone. The decode kernels run for
    tens of µs, less than the wrapper's host work, so events around
    back-to-back calls (``cuda_time_ms``) time the host. Here a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the ``iters`` calls, so the events around them see the
    card run them back to back. A window in which the host was still
    enqueueing when the spin ended is not a reading: it is taken again
    under a longer spin, and fails after SPIN_ATTEMPTS."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(SPIN_ATTEMPTS):
        spin_start, start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(3))
        spin_start.record()
        torch.cuda._sleep(SPIN_CYCLES << attempt)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_start.elapsed_time(start)
        if enqueue_ms < spin_ms:
            return start.elapsed_time(end) / iters
    fail(f'device_ms: enqueueing took {enqueue_ms:.2f} ms, longer than '
         f'the {spin_ms:.2f} ms spin that holds the stream')


@contextlib.contextmanager
def served_depth(ms_lib, params, layers):
    """A serving phase at MODEL's full width cut to its first ``layers``
    layers: the cut config registered in ``llama.CONFIGS`` under a name
    of its own and MODEL pointed at it while the phase runs; yields the
    params' first ``layers`` layers (views)."""
    global MODEL  # pylint: disable=global-statement
    import dataclasses
    full = MODEL
    name = f'{full}-{layers}l'
    configs = ms_lib.llama.CONFIGS
    configs[name] = dataclasses.replace(configs[full], n_layers=layers)
    MODEL = name
    try:
        yield dict(params, layers={k: w[:layers]
                                   for k, w in params['layers'].items()})
    finally:
        MODEL = full
        del configs[name]


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
                kernel_fn, card, idle_fns=(), on_engine=None):
    """One replica: start the port's server, answer ``requests`` (lists
    of (body) batches sent concurrently), check counts: ``kernel_fn``
    launched n_layers times per decode step (a speculative round is one
    step), each of ``idle_fns`` never. Returns (stats, [(body, reply)]);
    the stats add the engine's build seconds (``build_s``) and its
    weights' bytes in the HBM split (``weights_bytes``). ``on_engine``
    gets the engine last, its loop stopped."""
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
    stats['graphs'] = engine.graph_stats()
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
    if on_engine is not None:
        on_engine(engine)
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
# Host-clock samples a window (two windows an implementation). 20 before
# phase 19 was added; cut to keep the run inside its time limit.
PROFILE_TIMED_STEPS = 10


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
        # kernel, PROFILE_TIMED_STEPS each after 3 warm-up steps.
        samples = {'kernel': [], 'plain': []}
        for impl in ('kernel', 'plain', 'plain', 'kernel'):
            dcfg = decode.DecodeConfig(max_len=MAX_LEN, decode_attention=impl)
            for _ in range(3):
                step(dcfg)
            sync(torch)
            for _ in range(PROFILE_TIMED_STEPS):
                t0 = time.perf_counter()
                step(dcfg)
                sync(torch)
                samples[impl].append((time.perf_counter() - t0) * 1e3)
        stats = {impl: (statistics.median(v),
                        statistics.quantiles(v, n=10)[-1])
                 for impl, v in samples.items()}
        print(f'[profile] {label} decode step, 8 slots, live lengths '
              f'{PROFILE_LENS}, host clock (median / p90 of '
              f'{2 * PROFILE_TIMED_STEPS}): kernel '
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


def fp32_cut(torch, params, cfg16, layers=None):
    """llama3-8b's width at ``layers`` (default SPEC_PARITY_LAYERS)
    layers in fp32: (config, params cut from the bf16 ones)."""
    import dataclasses
    layers = layers or SPEC_PARITY_LAYERS
    cfg32 = dataclasses.replace(cfg16, n_layers=layers,
                                dtype=torch.float32)
    p32 = {'layers': {k: w[:layers].float()
                      for k, w in params['layers'].items()},
           **{k: w.float() for k, w in params.items() if k != 'layers'}}
    return cfg32, p32


def drain_engine(ms_lib, eng, prompts, n_new=None):
    """Submit ``n_new``-token (default N_NEW) requests for ``prompts``
    all at once and step the engine until every one finished; returns
    their tokens."""
    n_new = n_new or N_NEW
    reqs = [ms_lib.engine_lib.Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        if steps > 10 * n_new:
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
# (d) the params checkpoint at llama3-8b's width cut to RESTORE_LAYERS
# layers, 3.85 GB in bf16 (32, the model's depth and 16.06 GB, before
# the cut named at MODEL).
PARAMS_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'build', 'chip_smoke_params')
RESTORE_LAYERS = 4
PARAMS_CKPT_FREE = 5 * 10**9


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
    """(d) MODEL's bf16 params (phase 3's, drawn from seed 0; the caller
    cuts their depth: RESTORE_LAYERS) saved as a params checkpoint, then
    a replica built the CLI's way, ``build_engine(checkpoint_dir=...,
    int8=True, seed=1)`` with no params: it logs the restored step and
    its greedy tokens equal an in-memory dense int8 replica's of the
    same params on (b)'s prompts (``int8_dense``'s), while the same
    build without ``checkpoint_dir`` (seed 1's own weights) gives other
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
    prompts = [[body for body, _ in int8_dense[1]]]
    want_stats, want = serve_phase(torch, ms_lib, params,
                                   'in-memory int8-weights', {'int8': True},
                                   prompts, da.decode_attention_kernel, card)

    def differing(got):
        return sum(a['tokens'] != b['tokens']
                   for (_, a), (_, b) in zip(want, got))

    logs = _LogLines()
    server_logger = logging.getLogger(ms_lib.__name__)
    try:
        t0 = time.perf_counter()
        # Copies of the cut's views: torch.save writes a view's whole
        # storage.
        path = ckpt.save_params(PARAMS_CKPT_DIR, train.tree_map(
            lambda t: t.clone(), params), 1)
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
    with served_depth(ms_lib, params, RESTORE_LAYERS) as cut:
        restored = restore_phase(torch, ms_lib, da, train, cut,
                                 served['dense int8-weights'], card)
    del cut
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
# Phase 13's depth: 32 (the model's) before the cut named at MODEL.
PREFIX_LAYERS = 4


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
    """One paged llama3-8b replica of phases 13 and 16 on a local port,
    built the way a user starts one (``build_engine`` with
    ``prefix_peers`` or ``store_url``; the prefix fetch's budget through
    ``SKYTPU_PREFIX_FETCH_BUDGET_SECONDS``, other engine knobs through
    ``knobs``, each set while the engine reads it)."""

    def __init__(self, ms_lib, params, kv, port, peers=None, budget=None,
                 store_url=None, knobs=None):
        knobs = dict(knobs or {})
        if budget is not None:
            knobs['SKYTPU_PREFIX_FETCH_BUDGET_SECONDS'] = str(budget)
        os.environ.update(knobs)
        try:
            self.engine = ms_lib.build_engine(
                MODEL, 8, MAX_LEN, step_chunk=4, device=DEVICE,
                params=params, paged=True, kv_int8=kv == 'int8',
                prefix_peers=peers, store_url=store_url)
        finally:
            for name in knobs:
                os.environ.pop(name, None)
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
# Phase 15's depth: 32 (the model's) before the cut named at MODEL.
HANDOFF_LAYERS = 4


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


# -------------------------------------------------------------- phase 16


# Store budgets that complete at llama3-8b width (one 8-block entry is
# ~179 MB of base64 JSON in bf16), set through the knobs while each
# replica is built, as phase 13 sets its fetch budget; (f) runs the
# defaults (0.5 s fetch, 2 s spill) once, in bf16.
STORE_BUDGET = 60.0
STORE_KNOBS = {'SKYTPU_STORE_FETCH_BUDGET_SECONDS': str(STORE_BUDGET),
               'SKYTPU_STORE_SPILL_BUDGET_SECONDS': str(STORE_BUDGET)}
# The torn entry's prompt: 4 full blocks and a tail.
TORN_LEN = 512
# Phase 16's depth: 32 (the model's) before the cut named at MODEL.
STORE_LAYERS = 4


class StoreServer:
    """A ``--role store`` server over ``root``, started the way a user
    starts one: ``SKYTPU_STORE_DIR`` set while the server is built, which
    opens the block store there and rebuilds its index from disk. Its
    engine, built for every role as the reference builds it, serves no
    request."""

    def __init__(self, ms_lib, params, root):
        self.engine = ms_lib.build_engine(MODEL, 1, MAX_LEN, device=DEVICE,
                                          params=params, paged=True)
        os.environ['SKYTPU_STORE_DIR'] = root
        try:
            self.server = ms_lib.ModelServer(self.engine, 0,
                                             host='127.0.0.1', role='store')
        finally:
            os.environ.pop('SKYTPU_STORE_DIR', None)
        if self.server.store is None:
            fail('the store role opened no block store')
        self.port = self.server.start()
        self.url = f'http://127.0.0.1:{self.port}'

    def stats(self) -> dict:
        """``GET /prefix_blocks``: the hosted store's counters."""
        return get_json(self.port, '/prefix_blocks')

    def stop(self) -> dict:
        self.server.stop()
        return self.engine.stats()


def store_fetch_rows(ms_lib, replica, rid: str) -> list:
    """The ``engine.store_fetch`` rows of request ``rid``."""
    replica.engine.flush_journal()
    return [r['payload'] for r in ms_lib.journal.query(
        kinds=['engine.store_fetch'], trace_id=rid)]


def spill_settled(replica) -> int:
    """The spills the replica's loop has resolved, landed or failed."""
    cache = replica.engine.cache_stats()
    return cache['store_spills'] + cache['store_spill_failures']


def store_phase(torch, ms_lib, da, params, card):
    """Phase 16: the durable block store at llama3-8b width, bf16 and
    int8 K/V; launch counts reset by the caller. Returns the printed
    numbers by K/V dtype."""
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    bs = ms_lib.block_store
    rng = random.Random(16)
    spills = []
    real_spill = bs.http_store_spill

    def timed_spill(store_url, tokens, payload, budget_seconds):
        # The transport as the engine's spill thread calls it, timed: the
        # client's encode, the wire, the store's decode, re-encode and
        # write, the reply.
        t0 = time.perf_counter()
        ok = real_spill(store_url, tokens, payload, budget_seconds)
        spills.append({'blocks': (payload['matched_tokens'] -
                                  payload['from_tokens']) // BLOCK_K,
                       'raw_bytes': sum(a.nbytes for a in
                                        payload['arrays'].values()),
                       'seconds': round(time.perf_counter() - t0, 3),
                       'ok': ok})
        return ok

    # The engine binds its spill transport when it is built.
    bs.http_store_spill = timed_spill
    n_layers = cfg.n_layers
    steps = [0]
    out = {}
    root = tempfile.mkdtemp(prefix='chip_smoke_store_')

    def retire(r, live, spilled=False):
        # A replica that published a run first resolves its spill, so no
        # spill of a stopped replica runs beside the next measurement.
        if spilled:
            wait_for(lambda: spill_settled(r) >= 1, f'{kv}: a spill')
        steps[0] += r.stop()['decode_steps']
        live.remove(r)

    def replica(live, store=None, knobs=STORE_KNOBS):
        r = PrefixReplica(ms_lib, params, kv, 0,
                          store_url=store.url if store else None,
                          knobs=knobs if store else None)
        live.append(r)
        return r

    try:
        for kv in ('bf16', 'int8'):
            live = []
            del spills[:]
            try:
                prefix = rand_prompt(rng, cfg.vocab_size, PREFIX_LEN)

                def body(tail, head=prefix):
                    return {'prompt': head + rand_prompt(rng, cfg.vocab_size,
                                                         tail),
                            'max_new_tokens': N_NEW}

                owner_body = body(PREFIX_OWNER_TAIL)
                bodies = [body(n) for n in PREFIX_TAILS]
                store = StoreServer(ms_lib, params, os.path.join(root, kv))
                live.append(store)
                # (a) The owner's write-behind spill of its 8-block run.
                owner = replica(live, store)
                (_, owner_ttft), = owner.serve([owner_body],
                                               f'p16-{kv}-owner')
                wait_for(lambda: spill_settled(owner) >= 1,
                         f'{kv}: the owner\'s spill')
                ocache = owner.engine.cache_stats()
                if (ocache['store_spills'] != 1 or
                        ocache['store_spill_tokens'] != PREFIX_LEN or
                        ocache['store_fetch_misses'] != 1 or
                        [sp['blocks'] for sp in spills] !=
                        [PREFIX_LEN // BLOCK_K]):
                    fail(f'{kv}: owner spill {ocache}, spills {spills}')
                spill = dict(spills[0])
                stats = store.stats()
                if stats['entries'] != 1 or stats['spills'] != 1:
                    fail(f'{kv}: store after the spill {stats}')
                entry_bytes = stats['bytes']
                print(f'[store] {kv} (a) spill: {spill["blocks"]} blocks, '
                      f'{spill["raw_bytes"]} raw bytes, {entry_bytes} on '
                      f'disk, {spill["seconds"]:.3f}s; store {stats}',
                      flush=True)
                # The control: the owner's answers over its own cache, the
                # path a store-warmed replica takes (the prefix from its
                # radix cache, the tail prefilled over it).
                control = [t for t, _ in owner.serve(bodies,
                                                     f'p16-{kv}-control')]
                want = owner.engine.export_prefix_blocks(prefix, 0, 60.0)
                if want is None or want['matched_tokens'] != PREFIX_LEN:
                    fail(f'{kv}: the owner does not hold the prefix')
                retire(owner, live)
                # (b) The fleet is stopped: a fresh replica with no peers
                # fetches the prefix from the store.
                fetcher = replica(live, store)
                launched0 = da.paged_decode_attention_kernel.launches
                fetched = fetcher.serve(bodies, f'p16-{kv}-fetch')
                f_steps = fetcher.engine.stats()['decode_steps']
                f_launches = (da.paged_decode_attention_kernel.launches -
                              launched0)
                if f_launches != n_layers * f_steps or not f_steps:
                    fail(f'{kv}: the store-warmed replica launched the paged '
                         f'decode kernel {f_launches} times in {f_steps} '
                         'steps')
                for i, ((got, _), w) in enumerate(zip(fetched, control)):
                    if got != w:
                        fail(f'{kv}: prompt {i} over the store\'s prefix '
                             f'gave {got[:8]}..., the control {w[:8]}...')
                fcache = fetcher.engine.cache_stats()
                hits = [r for r in store_fetch_rows(ms_lib, fetcher,
                                                    f'p16-{kv}-fetch-0')
                        if r.get('outcome') == 'hit']
                if (fcache['store_fetch_hits'] != 1 or
                        fcache['store_fetch_tokens'] != PREFIX_LEN or
                        fcache['store_fetch_misses'] != 0 or len(hits) != 1
                        or hits[0]['tokens_gained'] != PREFIX_LEN):
                    fail(f'{kv}: store fetch counters {fcache}, rows {hits}')
                mine = fetcher.engine.export_prefix_blocks(prefix, 0, 60.0)
                if mine is None or mine['matched_tokens'] != PREFIX_LEN:
                    fail(f'{kv}: the fetcher does not hold the prefix')
                for name, t in want['arrays'].items():
                    if not torch.equal(mine['arrays'][name], t):
                        fail(f'{kv}: fetched {name} differs from the '
                             'owner\'s')
                planes = sorted(want['arrays'])
                del mine
                print(f'[store] {kv} (b) cold fetch: {hits[0]["seconds"]:.3f}s '
                      f'for {PREFIX_LEN} tokens (journal), first token '
                      f'{fetched[0][1]:.3f}s, paged-decode launches '
                      f'{f_launches} in {f_steps} steps, tokens and blocks '
                      'equal to the owner\'s', flush=True)
                retire(fetcher, live, spilled=True)
                # (c) A new store server over the same directory serves the
                # same fetch.
                retire(store, live)
                store = StoreServer(ms_lib, params, os.path.join(root, kv))
                live.append(store)
                stats = store.stats()
                if stats['entries'] != 1 or stats['bytes'] != entry_bytes:
                    fail(f'{kv}: the restarted store holds {stats}')
                again = replica(live, store)
                (got, restart_ttft), = again.serve(bodies[:1],
                                                   f'p16-{kv}-restart')
                rrows = [r for r in store_fetch_rows(ms_lib, again,
                                                     f'p16-{kv}-restart-0')
                         if r.get('outcome') == 'hit']
                if got != control[0] or len(rrows) != 1:
                    fail(f'{kv}: after the restart {got[:8]}..., rows '
                         f'{rrows}')
                print(f'[store] {kv} (c) restart: {stats["entries"]} entry '
                      f'loaded, fetch {rrows[0]["seconds"]:.3f}s, first token '
                      f'{restart_ttft:.3f}s', flush=True)
                retire(again, live, spilled=True)
                # (d) /prewarm with the family digest warms a fresh
                # replica; its next request is a local radix hit.
                warm = replica(live, store)
                os.environ['SKYTPU_PREWARM_BUDGET_SECONDS'] = str(STORE_BUDGET)
                t0 = time.perf_counter()
                try:
                    status, _, text = http_status(
                        warm.port, '/prewarm',
                        {'digests': [bs.family_digest(prefix)]})
                finally:
                    os.environ.pop('SKYTPU_PREWARM_BUDGET_SECONDS', None)
                prewarm_s = time.perf_counter() - t0
                reply = json.loads(text)
                if (status != 200 or reply.get('warmed') != 1 or
                        reply.get('tokens') != PREFIX_LEN):
                    fail(f'{kv}: /prewarm {status} {reply}')
                slo = get_json(warm.port, '/slo')['store']
                if (slo['prewarms'], slo['prewarm_tokens']) != (1,
                                                                PREFIX_LEN):
                    fail(f'{kv}: /slo store block {slo}')
                c0 = warm.engine.cache_stats()
                (got, prewarm_ttft), = warm.serve(bodies[:1],
                                                  f'p16-{kv}-prewarmed')
                c1 = warm.engine.cache_stats()
                if (got != control[0] or c1['store_fetch_hits'] or
                        c1['store_fetch_misses'] or
                        c1['prefill_tokens_saved'] - c0[
                            'prefill_tokens_saved'] < PREFIX_LEN):
                    fail(f'{kv}: prewarmed replica {got[:8]}..., {c1}')
                print(f'[store] {kv} (d) /prewarm: {prewarm_s:.3f}s, {reply}; '
                      f'then a radix hit, first token {prewarm_ttft:.3f}s, no '
                      'store fetch', flush=True)
                retire(warm, live, spilled=True)
                # (e) Degrades. store_down: plain prefill on the card,
                # the store backed off, the tokens a replica without a
                # store gives.
                cold = replica(live)
                (cold_tokens, cold_ttft), = cold.serve(bodies[:1],
                                                       f'p16-{kv}-cold')
                retire(cold, live)
                down = replica(live, store)
                os.environ['SKYTPU_CHAOS'] = 'store_down'
                try:
                    (got, _), = down.serve(bodies[:1], f'p16-{kv}-down')
                finally:
                    os.environ.pop('SKYTPU_CHAOS', None)
                drows = store_fetch_rows(ms_lib, down, f'p16-{kv}-down-0')
                if (got != cold_tokens or not down.engine.store_in_backoff()
                        or [r['outcome'] for r in drows] != ['down']):
                    fail(f'{kv}: store_down {got[:8]}... against '
                         f'{cold_tokens[:8]}..., rows {drows}')
                retire(down, live)
                # store_torn_entry: the spill the writer believes landed
                # reads as a miss, never as K/V.
                tbody = body(PREFIX_OWNER_TAIL,
                             rand_prompt(rng, cfg.vocab_size, TORN_LEN))
                writer = replica(live, store)
                torn0 = store.stats()['torn_dropped']
                os.environ['SKYTPU_CHAOS'] = 'store_torn_entry'
                try:
                    (torn_tokens, _), = writer.serve([tbody],
                                                     f'p16-{kv}-torn-write')
                    wait_for(lambda: spill_settled(writer) >= 1,
                             f'{kv}: the torn spill')
                finally:
                    os.environ.pop('SKYTPU_CHAOS', None)
                if writer.engine.cache_stats()['store_spills'] != 1:
                    fail(f'{kv}: the torn spill was not acknowledged')
                retire(writer, live)
                reader = replica(live, store)
                (got, _), = reader.serve([tbody], f'p16-{kv}-torn-read')
                trows = store_fetch_rows(ms_lib, reader,
                                         f'p16-{kv}-torn-read-0')
                torn = store.stats()['torn_dropped'] - torn0
                if (got != torn_tokens or torn != 1 or
                        [r['outcome'] for r in trows] != ['miss']):
                    fail(f'{kv}: torn entry: {torn} dropped, rows {trows}, '
                         f'tokens equal {got == torn_tokens}')
                print(f'[store] {kv} (e) degrades: store_down answered by '
                      f'prefill (cold first token {cold_ttft:.3f}s), the '
                      'store backed off; store_torn_entry read as a miss '
                      f'({torn} dropped)', flush=True)
                retire(reader, live, spilled=True)
                # (f) Once, in bf16: the default budgets' outcomes, the
                # requests answered in full either way.
                default = None
                if kv == 'bf16':
                    n0 = len(spills)
                    dspill = replica(live, store, knobs={})
                    dspill.serve([body(PREFIX_OWNER_TAIL,
                                       rand_prompt(rng, cfg.vocab_size,
                                                   PREFIX_LEN))],
                                 f'p16-{kv}-default-spill')
                    wait_for(lambda: spill_settled(dspill) >= 1,
                             f'{kv}: the default-budget spill')
                    retire(dspill, live)
                    dfetch = replica(live, store, knobs={})
                    (got, _), = dfetch.serve(bodies[:1],
                                             f'p16-{kv}-default-fetch')
                    frows = store_fetch_rows(ms_lib, dfetch,
                                             f'p16-{kv}-default-fetch-0')
                    retire(dfetch, live)
                    outcome = frows[-1]['outcome'] if frows else None
                    if got != (control[0] if outcome == 'hit'
                               else cold_tokens):
                        fail(f'default-budget fetch ({outcome}): tokens '
                             'differ from its control')
                    default = {
                        'spill': 'ok' if spills[n0]['ok'] else 'failed',
                        'spill_s': spills[n0]['seconds'],
                        'fetch': outcome,
                        'fetch_s': frows[-1]['seconds'] if frows else None}
                    print(f'[store] {kv} (f) default budgets: {default}',
                          flush=True)
                stats = store.stats()
                retire(store, live)
            finally:
                for r in live:
                    r.server.stop()
            out[kv] = {
                'spill': spill, 'entry_disk_bytes': entry_bytes,
                'spills': [(sp['blocks'], sp['seconds'], sp['ok'])
                           for sp in spills],
                'store_stats': stats,
                'fetch_s': hits[0]['seconds'],
                'fetch_s_per_block': round(hits[0]['seconds'] /
                                           (PREFIX_LEN // BLOCK_K), 4),
                'restart_fetch_s': rrows[0]['seconds'],
                'store_warmed_ttft_s': round(fetched[0][1], 3),
                'restart_ttft_s': round(restart_ttft, 3),
                'cold_ttft_s': round(cold_ttft, 3),
                'owner_cold_ttft_s': round(owner_ttft, 3),
                'prewarm_s': round(prewarm_s, 3),
                'prewarmed_ttft_s': round(prewarm_ttft, 3),
                'fetcher_launches': f_launches, 'fetcher_steps': f_steps,
                'planes': planes,
            }
            if default is not None:
                out[kv]['default_budgets'] = default
            print(f'[store] {kv}: spill of {spill["blocks"]} blocks '
                  f'({spill["raw_bytes"]} raw bytes, {entry_bytes} on disk) '
                  f'{spill["seconds"]:.3f}s, every spill (blocks, s, ok) '
                  f'{out[kv]["spills"]}; store-warmed fetch '
                  f'{hits[0]["seconds"]:.3f}s (journal), after a store '
                  f'restart {rrows[0]["seconds"]:.3f}s; first token '
                  f'{fetched[0][1]:.3f}s store-warmed, {prewarm_ttft:.3f}s '
                  f'prewarmed (/prewarm {prewarm_s:.3f}s), {cold_ttft:.3f}s '
                  f'cold; default budgets {default}; store {stats}; on '
                  f'{card}', flush=True)
            del want
            gc.collect()
            empty_cache(torch)
    finally:
        bs.http_store_spill = real_spill
        shutil.rmtree(root, ignore_errors=True)
    launched = da.paged_decode_attention_kernel.launches
    if launched != n_layers * steps[0] or not steps[0]:
        fail(f'phase 16: paged decode launched {launched} times, expected '
             f'n_layers x decode steps = {n_layers * steps[0]}')
    for fn in (da.decode_attention_kernel, da.paged_verify_attention_kernel):
        if fn.launches:
            fail(f'phase 16: {fn.__name__} launched {fn.launches} times')
    return out


# -------------------------------------------------------------- phase 17

# (b)-(d): per path, rounds run after every lane decodes (the graph
# path's captures happen there), then timed windows in turns (eager,
# graph, graph, eager) on the host clock, then rounds under
# torch.profiler. Lanes get GRAPH_MAX_NEW tokens, more than the rounds
# take, so all 8 stay live.
GRAPH_WARM_ROUNDS, GRAPH_TIMED_ROUNDS, GRAPH_PROFILED_ROUNDS = 3, 10, 5
# The spec round warms longer: its longest lane (1,000 tokens, ~1 token a
# round on random weights) crosses 1,024 positions within these rounds,
# where the drafter's block bucket grows from 8 to 16 (one capture), so
# the timed and profiled rounds all replay.
GRAPH_SPEC_WARM_ROUNDS = 30
GRAPH_MAX_NEW = 240
# (d) two long prompts arrive while 7 lanes decode, one after the other:
# the first captures the chunk shapes, the second's chunks are timed.
GRAPH_CHUNK_PROMPT = 1920
# (a)'s depth: 32 (the model's) before the cut named at MODEL; (b)-(d),
# the timed rounds, run at full depth.
GRAPH_SERVE_LAYERS = 4


def graph_serve_phase(torch, ms_lib, quant, da, decode, params,
                      dense_results, paged_batches, card):
    """(a) Phase 3's requests through graph and eager replicas of the
    port's ModelServer (``build_engine(rounds=...)``): dense bf16, paged
    bf16, paged int8 K/V, paged int8 weights, spec (spec_k SPEC_K,
    drafter depth 1), and paged with prefill_chunk PREFILL_CHUNK. Each
    replica's launches exact (serve_phase; the int8 GEMM's 7 per layer
    pass as phase 12 counts them, none elsewhere); tokens of the two
    paths identical, request by request; the graph replica captured
    each key once (its decode or spec kind and, paged, its prefill
    kinds) and replayed the rest, the eager one captured nothing; the
    chunked replicas' chunks as ``radix_chunks`` predicts. Returns the
    graph replicas' ``graph_stats`` by label."""
    cfg = ms_lib.llama.CONFIGS[MODEL]
    n_w = len(decode.QUANTIZED_WEIGHTS)
    dense_batch = [body for body, _ in dense_results]
    qparams = decode.quantize_params(params)
    dense_k, paged_k, verify_k = da.KERNELS
    want_chunks = radix_chunks(paged_batches, BLOCK_K, PREFILL_CHUNK)
    replicas = (
        ('dense bf16', params, {}, [dense_batch], dense_k, False),
        ('paged bf16', params, {'paged': True}, paged_batches, paged_k,
         False),
        ('paged int8-KV', params, {'paged': True, 'kv_int8': True},
         paged_batches, paged_k, False),
        ('paged int8-weights', qparams, {'paged': True}, paged_batches,
         paged_k, True),
        (f'spec k{SPEC_K} drafter 1', params,
         {'paged': True, 'spec_k': SPEC_K, 'drafter_layers': 1},
         paged_batches, verify_k, False),
        (f'paged bf16 chunk {PREFILL_CHUNK}', params,
         {'paged': True, 'prefill_chunk': PREFILL_CHUNK}, paged_batches,
         paged_k, False))
    report = {}
    for label, p, kwargs, batches, kernel, int8 in replicas:
        runs = {}
        for rounds in ('graph', 'eager'):
            name = f'{label} {rounds}'
            before = quant.int8_gemm_library.launches
            stats, results = serve_phase(
                torch, ms_lib, p, name, {'rounds': rounds, **kwargs},
                batches, kernel, card,
                idle_fns=[k for k in da.KERNELS if k is not kernel])
            gemms = quant.int8_gemm_library.launches - before
            expect = (n_w * cfg.n_layers * (stats['decode_steps'] +
                                            stats['admitted'])
                      if int8 else 0)
            if gemms != expect:
                fail(f'{name}: the int8 GEMM launched {gemms} times, '
                     f'expected {expect}')
            g = stats['graphs']
            if rounds == 'eager':
                if g != {'rounds': 'eager'}:
                    fail(f'{name}: {g}')
            else:
                kinds = set(g['captures'])
                want = {'spec_step' if kernel is verify_k
                        else 'decode_steps'}
                if kwargs.get('paged'):
                    want.add('paged_prefill')
                if (g['rounds'] != 'graph' or not want <= kinds
                        or g['graphs'] != sum(g['captures'].values())
                        or g['replays'] <= 0):
                    fail(f'{name}: graph stats {g}, captures of {want} '
                         'expected')
            if kwargs.get('prefill_chunk'):
                got = (stats['chunked_admissions'], stats['prefill_chunks'])
                if got != want_chunks:
                    fail(f'{name}: (chunked admissions, chunks) {got}, '
                         f'expected {want_chunks}')
            runs[rounds] = (stats, results)
        graph_toks = [r['tokens'] for _, r in runs['graph'][1]]
        eager_toks = [r['tokens'] for _, r in runs['eager'][1]]
        if graph_toks != eager_toks:
            fail(f'{label}: graph tokens {graph_toks} differ from eager '
                 f'{eager_toks}')
        g = runs['graph'][0]['graphs']
        report[label] = g
        print(f'[phase 17] {label}: {len(graph_toks)} requests token-'
              f'identical graph vs eager; graph replica: captures '
              f'{g["captures"]} in {g["capture_seconds"]:.3f}s, '
              f'{g["replays"]} replays, graph pool '
              f'{g["pool_bytes"]} bytes reserved '
              f'({g["pool_allocated_bytes"]} allocated), decode steps '
              f'{runs["graph"][0]["decode_steps"]} vs eager '
              f'{runs["eager"][0]["decode_steps"]}; on {card}', flush=True)
    del qparams
    empty_cache(torch)
    return report


def graph_rounds_profile(torch, eng, n):
    """``n`` rounds of ``eng`` under torch.profiler: (wall ms, device
    busy ms, kernels, graph launches) a round, and the rounds that
    replayed and captured (a spec round whose drafter block bucket is
    new captures)."""
    from torch.profiler import ProfilerActivity, profile

    def counts():
        g = eng.graph_stats()
        return g.get('replays', 0), sum(g.get('captures', {}).values())

    replays, captures = counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(torch, prof)
    graph_launches = sum(evt.count for evt in prof.key_averages()
                         if 'GraphLaunch' in evt.key)
    replays2, captures2 = counts()
    return (wall_ms / n, sum(r[0] for r in rows) / n,
            sum(r[2] for r in rows) / n, graph_launches / n,
            replays2 - replays, captures2 - captures)


def graph_timing_phase(torch, ms_lib, params, card):
    """(b) The paged bf16 decode round (8 lanes at PROFILE_LENS,
    step_chunk 4) and (c) the spec round (spec_k SPEC_K, drafter depth
    1), graph against eager: host ms a round and a decode step, median
    and p90 of 2 x GRAPH_TIMED_ROUNDS in turns, then the device's busy
    share, kernels and graph launches a round under torch.profiler; on
    the graph path each profiled round replays one graph (one
    ``cudaGraphLaunch``) or, once a new drafter bucket is reached,
    captures, and the eager path launches none. (d) The host ms a
    PREFILL_CHUNK-token chunk adds to a round of 7 decoding lanes (the
    median round with one chunk of a GRAPH_CHUNK_PROMPT-token prompt
    less the median round without), both paths."""
    import random
    cfg = ms_lib.llama.CONFIGS[MODEL]
    rng = random.Random(17)
    Request = ms_lib.engine_lib.Request

    def engine(rounds, **kw):
        return ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                   device=DEVICE, params=params, paged=True,
                                   rounds=rounds, **kw)

    def fill(eng, lens, warm=GRAPH_WARM_ROUNDS):
        reqs = [Request(rand_prompt(rng, cfg.vocab_size, n), GRAPH_MAX_NEW)
                for n in lens]
        for r in reqs:
            eng.submit(r)
        while not all(r.tokens for r in reqs):
            eng.step()
        for _ in range(warm):
            eng.step()
        return reqs

    def timed(eng, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.step()          # ends in the round's host fetch
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def summary(v):
        return statistics.median(v), statistics.quantiles(v, n=10)[-1]

    out = {}
    for label, kw, warm in (
            ('decode', {}, GRAPH_WARM_ROUNDS),
            ('spec', {'spec_k': SPEC_K, 'drafter_layers': 1},
             GRAPH_SPEC_WARM_ROUNDS)):
        engines = {r: engine(r, **kw) for r in ('eager', 'graph')}
        reqs = {r: fill(e, PROFILE_LENS, warm) for r, e in engines.items()}
        samples = {'eager': [], 'graph': []}
        for r in ('eager', 'graph', 'graph', 'eager'):
            samples[r] += timed(engines[r], GRAPH_TIMED_ROUNDS)
        res = {}
        for r, eng in engines.items():
            wall, busy, kernels, graphs, replayed, captured = \
                graph_rounds_profile(torch, eng, GRAPH_PROFILED_ROUNDS)
            if eng.active_slots() != len(PROFILE_LENS) or any(
                    q.done for q in reqs[r]):
                fail(f'phase 17 {label} {r}: a lane finished while timed')
            n_launched = round(graphs * GRAPH_PROFILED_ROUNDS)
            if (n_launched != replayed or (r == 'graph' and replayed +
                                           captured != GRAPH_PROFILED_ROUNDS)):
                fail(f'phase 17 {label} {r}: {n_launched} graph launches '
                     f'in {GRAPH_PROFILED_ROUNDS} profiled rounds, '
                     f'{replayed} replays and {captured} captures')
            med, p90 = summary(samples[r])
            res[r] = dict(round_ms=med, round_p90_ms=p90,
                          step_ms=med / 4 if label == 'decode' else None,
                          profiled_round_ms=wall, busy_ms=busy,
                          busy_share=busy / wall if wall else 0.0,
                          kernels=kernels, graph_launches=graphs,
                          captured=captured)
            print(f'[phase 17] {label} round, {r}: host {med:.3f} ms '
                  f'median / {p90:.3f} p90 of {len(samples[r])}'
                  + (f' ({med / 4:.3f} ms a decode step)'
                     if label == 'decode' else '')
                  + f'; profiled {wall:.3f} ms a round, device busy '
                  f'{busy:.3f} ms ({busy / wall:.3f} of the wall), '
                  f'{kernels:.0f} kernels and {graphs:.1f} graph launches '
                  f'a round ({captured} rounds captured); on {card}',
                  flush=True)
        res['graph_stats'] = engines['graph'].graph_stats()
        out[label] = res
        del engines, reqs
        gc.collect()
        empty_cache(torch)
    res = {}
    for r in ('graph', 'eager'):
        eng = engine(r, prefill_chunk=PREFILL_CHUNK)
        lanes = fill(eng, PROFILE_LENS[:7])
        plain = timed(eng, GRAPH_TIMED_ROUNDS)
        chunked = []
        for i in range(2):
            long = Request(rand_prompt(rng, cfg.vocab_size,
                                       GRAPH_CHUNK_PROMPT), 1)
            eng.submit(long)
            while not long.done:
                t = timed(eng, 1)
                if i == 1:
                    chunked += t
        if any(q.done for q in lanes):
            fail(f'phase 17 chunk {r}: a lane finished while timed')
        n_chunks = -(-GRAPH_CHUNK_PROMPT // PREFILL_CHUNK)
        if len(chunked) != n_chunks:
            fail(f'phase 17 chunk {r}: {len(chunked)} rounds for a '
                 f'{n_chunks}-chunk prompt')
        added = statistics.median(chunked) - statistics.median(plain)
        res[r] = dict(plain_round_ms=statistics.median(plain),
                      chunk_round_ms=statistics.median(chunked),
                      chunk_added_ms=added)
        print(f'[phase 17] chunk {PREFILL_CHUNK}, {r}: a round of 7 '
              f'decoding lanes {statistics.median(plain):.3f} ms, with one '
              f'chunk {statistics.median(chunked):.3f} ms: the chunk adds '
              f'{added:.3f} ms (host clock, medians of {len(plain)} and '
              f'{len(chunked)}); on {card}', flush=True)
        del eng, lanes
        gc.collect()
        empty_cache(torch)
    out['chunk'] = res
    return out


def graph_phase(torch, ms_lib, quant, da, decode, params, dense_results,
                paged_batches, card):
    """Phase 17: the compiled rounds, (a) graph_serve_phase at MODEL's
    width cut to GRAPH_SERVE_LAYERS layers, (b)-(d) graph_timing_phase
    at its full depth; prints the phase's own seconds."""
    t0 = time.perf_counter()
    with served_depth(ms_lib, params, GRAPH_SERVE_LAYERS) as cut:
        serve = graph_serve_phase(torch, ms_lib, quant, da, decode, cut,
                                  dense_results, paged_batches, card)
    del cut
    t1 = time.perf_counter()
    timing = graph_timing_phase(torch, ms_lib, params, card)
    seconds = time.perf_counter() - t0
    print(f'[phase 17] {seconds:.1f}s: (a) {t1 - t0:.1f}s, (b)-(d) '
          f'{seconds - (t1 - t0):.1f}s', flush=True)
    return {'serve': serve, 'timing': timing, 'seconds': seconds}


# -------------------------------------------------------------- phase 21


# (a) The static generate as the reference's decode bench runs it
# (skypilot_tpu/benchmark/decode_bench.py run_decode_bench, bench.py's
# decode payload): batch 32, a 128-token prompt, 128 new tokens, max_len
# prompt + new, greedy, without EOS; one eager call and, after the call
# that captures, STATIC_TIMED_CALLS replayed calls a config.
STATIC_B, STATIC_PROMPT, STATIC_NEW = 32, 128, 128
STATIC_TIMED_CALLS = 2
# (label, int8 weights, K/V dtype): bench.py's three decode payloads.
STATIC_CONFIGS = (('bf16', False, 'bf16'), ('int8 weights', True, 'bf16'),
                  ('int8 K/V', False, 'int8'))
# (b) The dense replica's insert at these prefill buckets, three prompt
# lengths each (the first captures on the graph path, the rest replay).
INSERT_LENS = {128: (100, 120, 128), 512: (300, 450, 512),
               2048: (1100, 1600, 2047)}
INSERT_MAX_LEN = 2048


def timed_call(torch, fn):
    """(seconds on the host clock, result) of one synchronised call."""
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return time.perf_counter() - t0, out


def static_generate_phase(torch, decode, llama, da, params, card):
    """(a) ``decode.generate`` at MODEL's full width and depth,
    STATIC_B x (STATIC_PROMPT + STATIC_NEW), under each of
    STATIC_CONFIGS: the eager loop (``rounds='eager'``) once, then the
    compiled program (the call that captures, then STATIC_TIMED_CALLS
    replayed calls): tokens identical, the dense decode kernel launched
    n_layers x (N - 1) times by every call, a bounded number of graph
    replays a call; seconds a call both ways, the prefill alone (a fresh
    cache and ``decode.prefill``, as decode_bench's ``prefill_only``)
    and decode tokens/s as decode_bench computes them: completed tokens
    / (generate - prefill)."""
    cfg = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (STATIC_B, STATIC_PROMPT),
                           generator=gen, device=dev)
    lens = torch.full((STATIC_B,), STATIC_PROMPT, dtype=torch.int64,
                      device=dev)
    per_call = cfg.n_layers * (STATIC_NEW - 1)
    n_rounds = 1 + -(-(STATIC_NEW - 1) // decode.GENERATE_ROUND)
    qparams = None
    report = {}
    for label, int8, kv in STATIC_CONFIGS:
        if int8 and qparams is None:
            qparams = decode.quantize_params(params)
        p = qparams if int8 else params
        dcfg = decode.DecodeConfig(max_len=STATIC_PROMPT + STATIC_NEW,
                                   kv_cache_dtype=kv)

        def call(rounds, p=p, dcfg=dcfg, label=label):
            before = da.decode_attention_kernel.launches
            secs, toks = timed_call(torch, lambda: decode.generate(
                p, prompt, lens, cfg, dcfg, STATIC_NEW, rounds=rounds))
            launched = da.decode_attention_kernel.launches - before
            if launched != per_call:
                fail(f'phase 21 (a) {label} {rounds}: the decode kernel '
                     f'launched {launched} times in a call, expected '
                     f'{per_call}')
            return secs, toks.cpu()

        eager_s, want = call('eager')
        capture_s, got = call('graph')
        (program,) = decode.generate_programs()
        replays0 = program.graphs.replays
        graph_s = []
        for _ in range(STATIC_TIMED_CALLS):
            secs, again = call('graph')
            graph_s.append(secs)
            if not torch.equal(again, want):
                fail(f'phase 21 (a) {label}: replayed tokens differ from '
                     f'the eager loop\'s')
        if not torch.equal(got, want):
            fail(f'phase 21 (a) {label}: the capturing call\'s tokens '
                 'differ from the eager loop\'s')
        launches = (program.graphs.replays - replays0) / STATIC_TIMED_CALLS
        if launches != n_rounds or sum(program.graphs.captures.values()) \
                != 3:
            fail(f'phase 21 (a) {label}: {launches} graph launches a '
                 f'call (expected {n_rounds}), captures '
                 f'{dict(program.graphs.captures)}')

        def prefill_only(p=p, dcfg=dcfg):
            cache = decode.init_kv_cache(cfg, STATIC_B, dcfg.max_len,
                                         dcfg.kv_cache_dtype, dev)
            return decode.prefill(p, prompt, cfg, cache, lens)

        prefill_s = min(timed_call(torch, prefill_only)[0]
                        for _ in range(2))
        completed = int(decode.completed_token_counts(want.numpy(),
                                                      None).sum())
        graph_med = statistics.median(graph_s)
        row = {'eager_s': eager_s, 'capture_call_s': capture_s,
               'graph_s': graph_s, 'prefill_s': prefill_s,
               'graph_launches_per_call': launches,
               'decode_launches_per_call': per_call,
               'capture_seconds': program.graphs.capture_seconds,
               'tokens_per_s_graph': completed / (graph_med - prefill_s),
               'tokens_per_s_eager': completed / (eager_s - prefill_s)}
        print(f'[phase 21] (a) {MODEL} {label}, {STATIC_B} x '
              f'({STATIC_PROMPT} + {STATIC_NEW}): a call {graph_med:.4f} s '
              f'replayed ({", ".join(f"{t:.4f}" for t in graph_s)}), '
              f'{eager_s:.4f} s eager, {capture_s:.4f} s the capturing '
              f'call ({program.graphs.capture_seconds:.3f} s of captures); '
              f'{launches:.0f} graph launches a call; prefill alone '
              f'{prefill_s:.4f} s; decode {row["tokens_per_s_graph"]:.1f} '
              f'tokens/s replayed, {row["tokens_per_s_eager"]:.1f} eager '
              f'({completed} tokens); decode kernel {per_call} launches a '
              f'call = {cfg.n_layers} x {STATIC_NEW - 1}; tokens identical;'
              f' on {card}', flush=True)
        report[label] = row
        decode.clear_generate_programs()
        empty_cache(torch)
    del qparams
    empty_cache(torch)
    return report


def dense_insert_phase(torch, ms_lib, params, card):
    """(b) The dense replica's insert at MODEL's full depth, a graph and
    an eager engine (2 lanes, max_len INSERT_MAX_LEN) given the same
    requests in turns, three lengths at each of INSERT_LENS' buckets; the
    first request holds lane 0 (2 new tokens), the rest are one-token
    requests into lane 1. Each insert's first token and its lane's K/V
    [L, :bucket] bit-equal on both engines; the graph engine captures
    once a bucket; TTFT on the host clock (the insert call, which reads
    the first token back) for each insert, the capturing ones apart."""
    import random
    rng = random.Random(21)
    cfg = ms_lib.llama.CONFIGS[MODEL]
    Request = ms_lib.engine_lib.Request
    engines = {rounds: ms_lib.build_engine(
        MODEL, 2, INSERT_MAX_LEN, device=DEVICE, params=params,
        rounds=rounds) for rounds in ('graph', 'eager')}
    ttft = {'graph': {}, 'eager': {}}
    first_request = True
    for bucket, lengths in INSERT_LENS.items():
        for i, n in enumerate(lengths):
            prompt = rand_prompt(rng, cfg.vocab_size, n)
            new = 2 if first_request else 1
            first_request = False
            got = {}
            for rounds, eng in engines.items():
                req = Request(prompt, new)
                secs, slot = timed_call(torch, lambda e=eng, r=req:
                                        e.insert(r))
                got[rounds] = (req.tokens[0], slot)
                key = 'capture' if rounds == 'graph' and i == 0 else bucket
                ttft[rounds].setdefault(key, []).append(secs)
            if got['graph'] != got['eager']:
                fail(f'phase 21 (b) bucket {bucket}, length {n}: first '
                     f'token and lane {got}')
            slot = got['graph'][1]
            for name, t in engines['graph']._cache.items():  # pylint: disable=protected-access
                want = engines['eager']._cache[name]  # pylint: disable=protected-access
                if not torch.equal(t[:, slot, :bucket],
                                   want[:, slot, :bucket]):
                    fail(f'phase 21 (b) bucket {bucket}, length {n}: lane '
                         f'{slot} {name} differs between graph and eager')
    stats = engines['graph'].graph_stats()
    if stats['captures'] != {'prefill': len(INSERT_LENS)}:
        fail(f'phase 21 (b): captures {stats["captures"]}, expected one '
             f'a bucket')
    if engines['eager'].graph_stats() != {'rounds': 'eager'}:
        fail(f'phase 21 (b): the eager engine {engines["eager"].graph_stats()}')
    for bucket in INSERT_LENS:
        g, e = ttft['graph'][bucket], ttft['eager'][bucket]
        print(f'[phase 21] (b) {MODEL} dense insert, bucket {bucket}: TTFT '
              f'{statistics.median(g) * 1e3:.3f} ms replayed '
              f'({", ".join(f"{t * 1e3:.3f}" for t in g)}), '
              f'{statistics.median(e) * 1e3:.3f} ms eager '
              f'({", ".join(f"{t * 1e3:.3f}" for t in e)}); first tokens '
              f'and lane K/V bit-equal; on {card}', flush=True)
    print(f'[phase 21] (b) capturing inserts '
          f'{", ".join(f"{t * 1e3:.1f}" for t in ttft["graph"]["capture"])}'
          f' ms; captures {stats["captures"]} in '
          f'{stats["capture_seconds"]:.3f} s; graph pool '
          f'{stats["pool_bytes"]} bytes', flush=True)
    return {'ttft_graph': ttft['graph'], 'ttft_eager': ttft['eager'],
            'captures': stats['captures']}


def compiled_dispatch_phase(torch, ms_lib, decode, llama, da, params,
                            card):
    """Phase 21: (a) the static generate and (b) the dense insert, graph
    against eager; prints the phase's own seconds."""
    t0 = time.perf_counter()
    static = static_generate_phase(torch, decode, llama, da, params, card)
    t1 = time.perf_counter()
    insert = dense_insert_phase(torch, ms_lib, params, card)
    seconds = time.perf_counter() - t0
    print(f'[phase 21] {seconds:.1f}s: (a) {t1 - t0:.1f}s, (b) '
          f'{seconds - (t1 - t0):.1f}s', flush=True)
    return {'static': static, 'insert': insert, 'seconds': seconds}


# --------------------------------------------------------------- phase 6


# -------------------------------------------------------------- phase 18

TP = 2
# Phase 18 runs both ranks on the one card, over gloo (each collective
# copies through host tensors) and eager rounds: a correctness run.
TP_DEVICES = ('cuda:0', 'cuda:0')
TP_BACKEND = 'gloo'
# Tokens a request of the served cases generates (bf16 tp=2 meets a
# near-tie within 0-18 tokens; the numeric check below is the bound).
TP_NEW = 8
# The fp32 cases' depth: exact parity needs no more layers (4 before
# phase 19 was added; cut to keep the run inside its time limit).
TP_FP32_LAYERS = 2
# Host ms of an eager decode round (the served replicas' 8 lanes and
# step_chunk 4), tp=2 against tp=1: prompt length, rounds timed.
TP_STEP_PROMPT, TP_STEP_TIMED = 64, 8
# The numeric check of every case: the prompts' lengths (random tokens,
# no prefix shared with anything served before) and the bound on
# max |logit(tp=2) - logit(tp=1)| / max |logit(tp=1)| over the last
# position of each prompt's prefill. Set from H100 readings of llama3-8b
# (PERF.md, PR 17): sound bf16 tp=2 0.0516-0.0598 in every case; with
# one all-reduce left out on every rank 0.1306-0.1345 (the last layer's
# w2), 0.2529-0.2932 (layer 15's w2), 1.4561-1.6189 (layer 0's wo).
# Int8 weights sum exactly on every rank: their logits are bit-equal.
TP_PROBE_LENS = (24, 300, 1100)
TP_LOGITS_REL_TOL = {'bf16': 0.09, 'int8': 0.0}
# Phase 18's depth: 32 (the model's) before the cut named at MODEL; the
# fp32 cases stay at TP_FP32_LAYERS.
TP_LAYERS = 4


def tp_kernel_check(torch, da, quant):
    """Kernels 2-3 against their twins at a rank's shard shape: Hkv/tp
    KV heads and H/tp query heads (llama3-8b at tp=2: 4 and 16), the
    serving block size and table width, bf16 and int8 K/V, verify at
    S = SPEC_K + 1. Returns {kernel: max abs err}."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1818)
    h, hkv = H // TP, HKV // TP
    nb = MAX_LEN // BLOCK_K
    n_pool = B * nb + 1
    tables = (torch.randperm(B * nb, generator=gen, device=dev) + 1).reshape(
        B, nb).to(torch.int32)
    k, v = (torch.randn(n_pool, BLOCK_K, hkv, HD, generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    pools = {'bf16': (k, v, None, None), 'int8': (kq, vq, ks, vs)}
    cur = torch.tensor(CUR_LENS, dtype=torch.int32, device=dev)
    start = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    errs = {}
    for name, s, lens in (('paged_decode_attention_kernel', 1, cur),
                          ('paged_verify_attention_kernel', SPEC_K + 1,
                           start)):
        q = torch.randn(B, s, h, HD, generator=gen, device=dev).bfloat16()
        kernel = getattr(da, name)
        plain = getattr(da, name.replace('_kernel', '_plain'))
        for kind, (kk, vv, kss, vss) in pools.items():
            args = (q, kk, vv, tables, lens, kss, vss)
            out = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = (out.float() - want.float()).abs().max().item()
            tol = KERNEL_ATOL[kind]
            print(f'[tp] {name} at the shard shape (H {h}, Hkv {hkv}) '
                  f'{kind}: max_abs_err={err:.3e} (tol {tol})', flush=True)
            if not (torch.isfinite(out).all() and err <= tol):
                fail(f'{name} at the shard shape {kind}: err {err} > {tol}')
            errs[f'{name} {kind}'] = err
    return errs


def tp_case(torch, ms_lib, llama, params, group, label, kwargs, batches,
            kernel_fn, card, export_prompt=None, weights='bf16',
            time_rounds=False):
    """One phase-18 case: a tp=1 control replica and a tp=2 replica on
    ``group``, both through build_engine and the ModelServer with eager
    rounds, on the same requests. Checks: the first-token logits of TP_PROBE_LENS fresh
    prompts within TP_LOGITS_REL_TOL[weights] of the control's
    (logits_rel_err); greedy tokens equal, a difference only at a near-
    tie of the control's logits (first_divergences, at most
    SPEC_PARITY_BF16_ULPS bf16 ulps; printed); every rank's pool holds
    [L, n_blocks, block_k, Hkv/tp, hd]; each rank launched ``kernel_fn``
    n_layers x decode steps in the tp=2 run, and the worker every kernel
    as often as rank 0 (``rank_stats``: each rank's launches since the
    engine was built). With ``export_prompt``: the tp=2 replica's export of it
    against the control's (fields, planes, shapes, dtypes; layer 0 bit-
    equal), and a fresh tp=1 engine that installs it continues as the
    control did. With ``time_rounds``: the host ms of an eager decode
    round on each replica (:func:`round_ms`). Returns a summary."""
    t0 = time.perf_counter()
    cfg = llama.CONFIGS[MODEL]
    seen = {}
    probes = tp_probe_prompts(cfg)

    def keep(side):
        def on_engine(engine):
            if export_prompt is not None:
                seen[side + '_export'] = engine._export_prefix_now(  # pylint: disable=protected-access
                    export_prompt)
            if side == 'tp2':
                seen['ranks'] = engine.rank_stats(reset=True)
            seen[side + '_logits'] = first_logits(torch, ms_lib, engine,
                                                  probes)
            if time_rounds:
                seen[side + '_round_ms'] = round_ms(torch, ms_lib, engine)
            if side == 'tp2':
                engine.close()
        return on_engine

    ctl_stats, ctl = serve_phase(torch, ms_lib, params, f'{label} tp=1',
                                 dict(kwargs, rounds='eager'), batches,
                                 kernel_fn, card, on_engine=keep('tp1'))
    group_kwargs = dict(kwargs, tp=TP, tp_group=group, rounds='eager')
    stats, got = serve_phase(torch, ms_lib, params, f'{label} tp={TP}',
                             group_kwargs, batches, kernel_fn, card,
                             on_engine=keep('tp2'))
    if stats['tp'] != TP:
        fail(f'{label}: stats tp {stats["tp"]}')
    rel = logits_rel_err(torch, seen['tp1_logits'], seen['tp2_logits'],
                         TP_LOGITS_REL_TOL[weights], f'{label} tp={TP}',
                         card)
    pairs = [(body['prompt'], a['tokens'], b['tokens'])
             for (body, a), (_, b) in zip(ctl, got)]
    div = first_divergences(torch, llama, params, cfg, pairs,
                            SPEC_PARITY_BF16_ULPS, f'{label} tp={TP}')
    ranks = seen['ranks']
    n_blocks = stats['blocks_total'] + 1
    want_shape = (cfg.n_layers, n_blocks, BLOCK_K, cfg.n_kv_heads // TP,
                  cfg.head_dim)
    deltas = [r['launches'] for r in ranks]
    for r in ranks:
        if tuple(r['pool_shapes']['k']) != want_shape:
            fail(f'{label}: rank {r["rank"]} pool {r["pool_shapes"]}, '
                 f'expected k {want_shape}')
    expect = cfg.n_layers * stats['decode_steps']
    for r, d in zip(ranks, deltas):
        if d != deltas[0] or d[kernel_fn.__name__] != expect:
            fail(f'{label}: rank {r["rank"]} launched {d}; rank 0 '
                 f'{deltas[0]}; {kernel_fn.__name__} expected {expect}')
    peaks = [r['max_memory_allocated'] for r in ranks]
    print(f'[tp] {label}: {len(pairs) - len(div)}/{len(pairs)} requests '
          f'token-identical to tp=1, {len(div)} near-tie divergences '
          f'{div}; every rank pool k {want_shape}; per-rank launches '
          f'{deltas} ({kernel_fn.__name__} = n_layers x '
          f'{stats["decode_steps"]} steps); per-rank peak memory '
          f'{[round(p / 2**30, 2) for p in peaks]} GiB (gloo through the '
          f'host, both ranks on one card); on {card}', flush=True)
    launched = deltas[0][kernel_fn.__name__]
    out = {'identical': len(pairs) - len(div), 'requests': len(pairs),
           'logits_rel_err': rel, 'near_ties': div, 'launches': launched,
           'peak_gib': [round(p / 2**30, 3) for p in peaks],
           'tp1_decode_steps': ctl_stats['decode_steps'],
           'tp2_decode_steps': stats['decode_steps']}
    if time_rounds:
        out['round_ms'] = {'tp1': seen['tp1_round_ms'],
                           f'tp{TP}': seen['tp2_round_ms']}
        print(f'[tp] {label}: host ms of an eager decode round (8 lanes, '
              f'step_chunk 4, llama3-8b; median of {TP_STEP_TIMED}): '
              f'tp=1 {seen["tp1_round_ms"]:.3f}, tp={TP} '
              f'{seen["tp2_round_ms"]:.3f} (tp={TP}: two ranks on one '
              f'card, collectives over gloo through the host: '
              f'{group.path}; a correctness run, not a TP speed number) '
              f'on {card}', flush=True)
    if export_prompt is not None:
        out['export'] = tp_export_check(torch, ms_lib, llama, params,
                                        seen['tp1_export'],
                                        seen['tp2_export'], export_prompt,
                                        ctl, kwargs, label)
    out['seconds'] = round(time.perf_counter() - t0, 1)
    print(f'[time] phase 18 {label}: {out["seconds"]}s', flush=True)
    return out


def round_ms(torch, ms_lib, engine):
    """Median host ms of one eager decode round of ``engine`` (its loop
    stopped; every lane decoding): TP_STEP_TIMED rounds after one warm
    round, each timed to the card's sync."""
    import random
    import statistics
    rng = random.Random(18)
    vocab = ms_lib.llama.CONFIGS[MODEL].vocab_size
    lanes = engine.num_slots
    reqs = [ms_lib.engine_lib.Request(
        [rng.randrange(vocab) for _ in range(TP_STEP_PROMPT)],
        engine.step_chunk * (TP_STEP_TIMED + 16)) for _ in range(lanes)]
    for r in reqs:
        engine.submit(r)
    while engine.active_slots() < lanes or any(
            st is not None for st in engine._prefill_state):  # pylint: disable=protected-access
        engine.step()
    engine.step()
    times = []
    for _ in range(TP_STEP_TIMED):
        sync(torch)
        t0 = time.perf_counter()
        engine.step()
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    if any(r.done for r in reqs):
        fail(f'{engine.name}: a lane finished inside the timed rounds')
    return statistics.median(times)


def tp_probe_prompts(cfg):
    """The numeric check's prompts: random tokens of TP_PROBE_LENS."""
    import random
    rng = random.Random(1818)
    return [[rng.randrange(cfg.vocab_size) for _ in range(n)]
            for n in TP_PROBE_LENS]


def first_logits(torch, ms_lib, engine, prompts):
    """Each prompt's first-token logits [V] (fp32, on the host): the
    last position of its prefill, taken where the engine samples the
    first token, one 1-token request at a time through ``submit`` and
    ``step`` (the engine's loop stopped). Under TP rank 0 holds them
    gathered over the vocab slices, after every row-parallel sum of
    the forward."""
    got = []
    sample = engine._sample_first  # pylint: disable=protected-access

    def record(last):
        got.append(last.float().cpu())
        return sample(last)

    engine._sample_first = record  # pylint: disable=protected-access
    try:
        for p in prompts:
            req = engine.submit(ms_lib.engine_lib.Request(p, 1))
            for _ in range(10 * len(p)):
                if req.done:
                    break
                engine.step()
            if not req.done or req.finish_reason != 'length':
                fail(f'{engine.name}: probe request {req.finish_reason}')
    finally:
        del engine._sample_first  # pylint: disable=protected-access
    if len(got) != len(prompts):
        fail(f'{engine.name}: {len(got)} first-token logits for '
             f'{len(prompts)} prompts')
    return torch.stack(got)


def logits_rel_err(torch, want, got, tol, label, card):
    """max |got - want| / max |want| of each prompt's first-token
    logits (tp=2 against tp=1), each at most ``tol``; returns the
    per-prompt errors."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f'{label}: first-token logits {tuple(got.shape)} vs '
             f'{tuple(want.shape)}, finite {torch.isfinite(got).all()}')
    rel = ((got - want).abs().amax(-1) /
           want.abs().amax(-1)).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f'[tp] {label}: first-token logits of {len(rel)} prompts '
          f'(lengths {list(TP_PROBE_LENS)}) against tp=1: max|diff| / '
          f'max|logit| = {rel} (tol {tol}), argmax equal {same}; on '
          f'{card}', flush=True)
    if not max(rel) <= tol:
        fail(f'{label}: first-token logits differ from tp=1 by '
             f'{max(rel)} of the largest logit > {tol}')
    return rel


def tp_export_check(torch, ms_lib, llama, params, p1, p2, prompt, ctl,
                    kwargs, label):
    """The tp=2 export against the tp=1 control's: the same fields and
    planes, shapes and dtypes (the unsharded [L, n, block_k, Hkv, ...]),
    layer 0 bit-equal (no reduction reaches it; the later layers carry
    the row-parallel sums' rounding). A fresh tp=1 engine installs the
    tp=2 payload and continues a request that extends the prefix: its
    tokens against the control's, near-tie rule as above."""
    if p1 is None or p2 is None:
        fail(f'{label}: no export ({p1 is None}, {p2 is None})')
    if {k: v for k, v in p2.items() if k != 'arrays'} != \
            {k: v for k, v in p1.items() if k != 'arrays'}:
        fail(f'{label}: export fields differ')
    worst = {}
    for name, a in p1['arrays'].items():
        b = p2['arrays'].get(name)
        if b is None or (b.shape, b.dtype) != (a.shape, a.dtype):
            fail(f'{label}: export plane {name} differs in form')
        if not torch.equal(b[0], a[0]):
            fail(f'{label}: export plane {name} layer 0 differs')
        worst[name] = (b.float() - a.float()).abs().max().item()
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params, **kwargs)
    gained = engine._install_remote_blocks(prompt, p2, [], 0)  # pylint: disable=protected-access
    if gained != p2['matched_tokens']:
        fail(f'{label}: the tp=1 engine installed {gained} tokens')
    body, want = next((b, r) for b, r in ctl
                      if b['prompt'][:len(prompt)] == prompt)
    tokens = drain_engine(ms_lib, engine, [body['prompt']],
                          len(want['tokens']))[0]
    saved = engine.stats()['prefill_tokens_saved']
    del engine
    empty_cache(torch)
    div = first_divergences(torch, llama, params, llama.CONFIGS[MODEL],
                            [(body['prompt'], want['tokens'], tokens)],
                            SPEC_PARITY_BF16_ULPS, f'{label} tp=2 export')
    print(f'[tp] {label}: export of {p2["matched_tokens"]} tokens, '
          f'planes {sorted(p2["arrays"])} of shape '
          f'{tuple(p2["arrays"]["k"].shape)}, layer 0 bit-equal to '
          f'tp=1, max |diff| by plane {worst}; a tp=1 engine installed it '
          f'({saved} prompt tokens saved) and continued '
          f'{"token-identical" if not div else div} to the control',
          flush=True)
    if saved < p2['matched_tokens']:
        fail(f'{label}: the installed prefix was not reused ({saved})')
    return {'tokens': p2['matched_tokens'], 'max_diff': worst,
            'continued_identical': not div}


def tp_fp32_phase(torch, ms_lib, decode, llama, params, group, prompts,
                  card):
    """tp=2 against tp=1 where no near-tie can hide a fault: fp32 at
    llama3-8b's width and TP_FP32_LAYERS layers, whose TP sums round in
    fp32, far below any top-1/top-2 gap. Paged,
    int8 K/V, spec (spec_k SPEC_K, drafter depth 1) and chunked
    (PREFILL_CHUNK) engines, tp=2 on ``group`` (eager rounds) and tp=1,
    N_NEW tokens for each prompt: identical in every request."""
    cfg32, p32 = fp32_cut(torch, params, llama.CONFIGS[MODEL],
                          TP_FP32_LAYERS)
    cases = {'paged': ({}, 0), 'int8-KV': ({'kv_cache_dtype': 'int8'}, 0),
             'spec': ({'spec_k': SPEC_K, 'spec_drafter_layers': 1}, 0),
             'chunked': ({}, PREFILL_CHUNK)}
    out = {}
    for label, (dcfg_kw, chunk) in cases.items():
        dcfg = decode.DecodeConfig(max_len=MAX_LEN, **dcfg_kw)
        tokens = {}
        for tp in (1, TP):
            eng = ms_lib.engine_lib.DecodeEngine(
                p32, cfg32, dcfg, 8, step_chunk=4, paged=True,
                prefill_chunk=chunk, tp=tp,
                tp_group=group if tp > 1 else None,
                rounds='eager' if tp > 1 else 'graph')
            tokens[tp] = drain_engine(ms_lib, eng, prompts)
            eng.close()
            del eng
        pairs = list(zip(prompts, tokens[1], tokens[TP]))
        first_divergences(torch, llama, p32, cfg32, pairs, None,
                          f'tp fp32 {label}')
        print(f'[tp] fp32 {TP_FP32_LAYERS} layers {label}: tp={TP} '
              f'tokens equal tp=1\'s in all {len(pairs)} requests '
              f'({N_NEW} each) on {card}', flush=True)
        out[label] = len(pairs)
    del p32
    empty_cache(torch)
    return out


def nccl_graph_check(torch, tp_lib, card):
    """The only NCCL check one card allows: a one-rank NCCL group whose
    all_reduce and all_gather are captured in a CUDA graph and replayed
    over new inputs."""
    group = tp_lib.local_group(1, ['cuda:0'], 'nccl')
    try:
        x = torch.zeros(4096, device='cuda')
        group.all_reduce(x.clone())          # the communicator, eagerly
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            group.all_reduce(x * 2)
            group.all_gather(x[None], dim=0)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = group.all_reduce(x * 2)
            z = group.all_gather(x[None] + 1, dim=0)
        for value in (1.0, 3.0):
            x.fill_(value)
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(y, x * 2) and torch.equal(z[0], x + 1)):
                fail(f'nccl graph replay: {y[:2]} {z[0, :2]} for {value}')
        print(f'[tp] a one-rank nccl group ({group.path}): all_reduce and '
              'all_gather captured in a CUDA graph, replayed over two '
              f'inputs, results equal; on {card}', flush=True)
    finally:
        group.close()
    return 'captured and replayed'


def tp_phase(torch, ms_lib, da, quant, decode, llama, params, paged_batches,
             card):
    """Phase 18: the TP replica. llama3-8b at full width (the caller cuts
    its depth: TP_LAYERS) served tensor-parallel at tp=2 with both ranks
    on the one card (gloo, eager rounds; the CLI's --tp takes a card a
    rank over NCCL, which one card cannot show), each case against a
    tp=1 control: bf16 and int8 K/V, spec_k SPEC_K at drafter depth 1,
    chunked prefill PREFILL_CHUNK and int8 weights, TP_NEW tokens a
    request (the bf16 case also times an eager decode round on both);
    the same in fp32 at TP_FP32_LAYERS
    layers, tokens exactly equal. Before them kernels 2-3 at the shard
    shape; after, a one-rank NCCL group's captured collectives. Returns
    the report."""
    from skypilot_tpu_torch.parallel import tp as tp_lib
    report = {}
    if DEVICE == 'cuda':
        report['shard_kernels'] = tp_kernel_check(torch, da, quant)
    group = tp_lib.local_group(TP, [DEVICE] * TP if DEVICE == 'cpu'
                               else list(TP_DEVICES), TP_BACKEND)
    print(f'[tp] group: {TP} ranks on {[str(d) for d in group.devices]}, '
          f'collectives {group.path}', flush=True)
    if DEVICE == 'cuda':
        torch.cuda.reset_peak_memory_stats()

    batches = [[dict(body, max_new_tokens=TP_NEW) for body in batch]
               for batch in paged_batches]

    def case(label, kwargs, kernel_fn, p=params, **kw):
        return tp_case(torch, ms_lib, llama, p, group, label, kwargs,
                       batches, kernel_fn, card, **kw)

    try:
        shared = paged_batches[0][0]['prompt'][:256]
        report['bf16'] = case('tp paged bf16', {'paged': True},
                              da.paged_decode_attention_kernel,
                              export_prompt=shared, time_rounds=True)
        report['int8_kv'] = case('tp paged int8-KV',
                                 {'paged': True, 'kv_int8': True},
                                 da.paged_decode_attention_kernel)
        report['spec'] = case('tp spec', {'paged': True, 'spec_k': SPEC_K,
                                          'drafter_layers': 1},
                              da.paged_verify_attention_kernel)
        report['chunked'] = case('tp chunked',
                                 {'paged': True,
                                  'prefill_chunk': PREFILL_CHUNK},
                                 da.paged_decode_attention_kernel)
        t0 = time.perf_counter()
        report['fp32'] = tp_fp32_phase(
            torch, ms_lib, decode, llama, params, group,
            [body['prompt'] for batch in paged_batches for body in batch],
            card)
        print(f'[time] phase 18 fp32: {time.perf_counter() - t0:.1f}s',
              flush=True)
        qparams = decode.quantize_params(params)
        report['int8_weights'] = case('tp int8 weights', {'paged': True},
                                      da.paged_decode_attention_kernel,
                                      p=qparams, weights='int8')
        del qparams
        empty_cache(torch)
    finally:
        group.close()
    if DEVICE == 'cuda':
        report['nccl_graph'] = nccl_graph_check(torch, tp_lib, card)
    return report


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


def atol_need(got, want, rtol):
    """Per element, the least atol (in units of its row scale) that it
    needs at ``rtol`` under twin_error's bf16 rule."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - rtol * want.abs()) / row_scale(want)


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
    atol = atol_need(got, want, tol['rtol']).max().item()
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
    checkpointed train_loop cut and resumed (at RESUME_LAYERS layers).
    Returns the launch counts of the main-path steps."""
    import dataclasses
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

    # Cut and resume: the step after a restore equals the unbroken run's
    # (at RESUME_LAYERS layers).
    cut_cfg = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    ckpt_dir = CKPT_DIR
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    runs = {}
    for label, n, ckpt in (('unbroken', 3, None), ('cut', 2, ckpt_dir),
                           ('resumed', 3, ckpt_dir)):
        seen = runs[label] = {}
        t0 = time.perf_counter()
        end = train.train_loop(
            cut_cfg, tc, n, TRAIN_B, TRAIN_S, checkpoint_dir=ckpt,
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


# -------------------------------------------------------------- phase 19

# bench-1b on a (data 1, fsdp 2, model 2) mesh of four ranks sharing the
# one card over gloo (host copies; the CLI's default, NCCL with a card a
# rank, needs four cards), a global batch of 4 x 2048.
SHARD_MESH = dict(data=1, fsdp=2, model=2)
SHARD_RANKS = 4
SHARD_B = 4
SHARD_STEPS = 3
SHARD_SAVE_AT = 2
# (c) and (c')'s depth in fp32: 4 before (c') was added; cut to keep the
# run inside its time limit (the 2e-5 contract needs no more layers).
SHARD_FP32_LAYERS = 2
# Adam at a visible rate: step 1 runs at 0 (the warm-up's first count),
# steps 2-3 at ~3e-4, so the params after 3 steps moved by a few bf16
# ulps.
SHARD_TRAIN = dict(learning_rate=3e-4, warmup_steps=1)
# Kernels 4-6 at a rank's shard shape: (B/fsdp, S, H/model, Hkv/model,
# D, causal).
SHARD_FLASH_CASE = (2, 2048, 8, 4, 128, True)
# The sharded run against the one-rank control, relative: each step's
# loss and grad norm, and the params after the last step as
# ||p - p_control|| / ||p_control - p_0|| (the difference against the
# control's own update). bf16: set between the sound readings on an
# H100 (700 W; loss <= 5.7e-5, grad norms equal, params 0.111) and those
# with one row-parallel all-reduce left out on every rank (layer 0's wo:
# loss >= 4.6e-4, grad norm >= 0.19, params 1.37; the last layer's w2:
# loss 1.2e-4 at step 3, grad norm >= 0.012, params 0.133); one bf16
# ulp of a norm near 5 is 0.006. fp32 loss and grad norm: the training
# contract; its params read 9.0e-5.
SHARD_TOL = {'bf16': dict(loss=1e-4, grad_norm=8e-3, params=0.5),
             'fp32': dict(loss=2e-5, grad_norm=2e-5, params=1e-3)}
# The reference's own bound on its sharded step's first bf16 loss
# (tests/unit_tests/test_models.py::test_sharded_train_step_dp_fsdp_tp).
SHARD_STEP1_RTOL = 5e-3
SHARD_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'build', 'chip_smoke_shard_ckpt')
# (b') bench-1b under 'dots' (the fastest policy on one card) on (b)'s
# mesh and batches for its first SHARD_DOTS_STEPS steps: against the
# control within SHARD_TOL['bf16'] and against (b)'s 'full' bit for bit.
# (c') SHARD_FP32_POLICIES at (c)'s depth in fp32, bit-equal to (c)'s
# first SHARD_FP32_POLICY_STEPS steps (a step's loss and grad norm read
# every grad; one step keeps the run inside its time limit).
SHARD_DOTS_STEPS = 2
SHARD_FP32_POLICIES = ('ffn', 'ffn1')
SHARD_FP32_POLICY_STEPS = 1
# (b') the bytes one block's backward keeps on a rank against the
# arithmetic at the rank's shard widths (its rows of the batch; H/model,
# Hkv/model and ffn/model columns; wo's partial product before the sum
# over 'model'), relative.
SHARD_KEPT_REL_TOL = 0.05
# (d) the sharded save's files against the state's bytes: each slice
# written once, so their sum is the state's plus each file's pickle.
SHARD_SAVE_OVERHEAD = 0.01
# (e) ResNet-50 data parallel over two ranks on the card (phase 14's
# model, size, batch and learning rate) against a one-rank control on
# the same batch: each step's loss, relative, at the reference's bf16
# rtol. The second rank's rows are scaled and shifted, so each rank
# normalising its own rows (local BN) reads far from the control while
# sync BN, exact in the math, stays near it (readings: PERF.md section
# 6, PR 18).
RESNET_DP_SKEW = (3.0, 1.0)
RESNET_DP_RANKS, RESNET_DP_STEPS = 2, 2
RESNET_DP_TOL = 5e-3


def kernel_twin_check(torch, fa, case, phase, seed):
    """Kernels 4-6 against their twins at ``case`` (B, S, H, Hkv, D,
    causal), bf16 and fp32, under twin_error's bounds; any failure fails
    ``phase``. Returns the worst max abs error of each kernel by
    dtype."""
    b, s, h, hkv, d, causal = case
    dev = torch.device('cuda')
    worst = {}
    for dtype_name, dtype in (('bf16', torch.bfloat16),
                              ('fp32', torch.float32)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        q, k, v, g = (torch.randn(shape, generator=gen,
                                  device=dev).to(dtype)
                      for shape in ((b, s, h, d), (b, s, hkv, d),
                                    (b, s, hkv, d), (b, s, h, d)))
        out, lse = fa.flash_forward_kernel(q, k, v, causal)
        dsum = fa.row_dot(g, out)
        dq = fa.flash_bwd_dq_kernel(q, k, v, g, lse, dsum, causal)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, g, lse, dsum, causal)
        p_out, p_lse = fa.flash_forward_plain(q, k, v, causal)
        grads = fa.flash_backward_plain(q, k, v, out, lse, g, causal)
        if not (lse - p_lse).abs().max().item() <= 1e-4:
            fail(f'{phase} flash forward {dtype_name}: LSE differs')
        for name, got, want in (
                ('flash_forward_kernel', out, p_out),
                ('flash_bwd_dq_kernel', dq, grads[0]),
                ('flash_bwd_dkv_kernel dk', dk, grads[1]),
                ('flash_bwd_dkv_kernel dv', dv, grads[2])):
            err, msg = twin_error(got, want, dtype_name)
            print(f'[{phase}] {name} at {case} {dtype_name}: {msg}',
                  flush=True)
            if err is not None:
                fail(f'{phase} {name} at {case} {dtype_name}: {err}')
            key = f'{name.split()[0]} {dtype_name}'
            worst[key] = max(worst.get(key, 0.0),
                             (got.float() - want.float()).abs().max().item())
        del q, k, v, g, out, lse, dsum, dq, dk, dv, p_out, p_lse, grads
    torch.cuda.empty_cache()
    return worst


def shard_config(llama, model, dtype_name, layers=None, policy='full'):
    """``model`` as phase 7 trains it (flash, remat, its own ce_chunks)
    under remat ``policy``, in ``dtype_name``, cut to ``layers`` when
    given."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(llama.CONFIGS[model], flash_attention=True,
                              remat=True, remat_policy=policy)
    if dtype_name == 'fp32':
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _sync(torch, dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def block_kept_bytes(torch, llama, cfg, state, mesh, rows, seq, dev):
    """(b'), on every rank: what one ``remat_block`` of layer 0 keeps for
    its backward on this rank, against the arithmetic at its shard
    widths. The checkpoint's inputs come through
    ``torch.autograd.graph.saved_tensors_hooks`` (which see nothing the
    selective policy keeps: non-reentrant checkpointing packs the
    region's tensors with hooks of its own), the kept GEMM outputs as
    the storages the block's ops made that outlive it (a
    ``TorchDispatchMode`` holding weak references), less its output.
    Returns the bytes measured and computed, the kept tensors' shapes
    (as their first op made them) and those of the block's gathered
    weights still alive after it (none: the recompute gathers again)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    class Made(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.made.append((StorageWeakRef(t.untyped_storage()),
                                      t.untyped_storage().nbytes(),
                                      tuple(t.shape)))
            return out

    layer = {n: w[0] for n, w in state.params['layers'].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(19 + mesh.rank)
    x = torch.randn((rows, seq, cfg.dim), generator=gen, device=dev
                    ).to(cfg.dtype).requires_grad_()
    cos, sin = llama._rope_freqs(  # pylint: disable=protected-access
        cfg, torch.arange(seq, device=dev))
    packed = {}

    def pack(t):
        packed[StorageWeakRef(t.untyped_storage()).cdata] = (
            t.untyped_storage().nbytes())
        return t

    gathered = []
    plain_gathered = llama._gathered  # pylint: disable=protected-access

    def recorded(layer, mesh, names):
        out = plain_gathered(layer, mesh, names)
        gathered.extend((n, StorageWeakRef(out[n].untyped_storage()))
                        for n in names)
        return out

    mode = Made()
    llama._gathered = recorded  # pylint: disable=protected-access
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            with mode:
                out = llama.remat_block(cfg, x, layer, cos, sin, mesh=mesh)
    finally:
        llama._gathered = plain_gathered  # pylint: disable=protected-access
    gc.collect()
    known = {StorageWeakRef(t.untyped_storage()).cdata
             for t in [x, cos, sin, out, *layer.values()]}
    kept = {}
    for ref, nbytes, shape in mode.made:
        if not ref.expired() and ref.cdata not in known:
            kept.setdefault(ref.cdata, (nbytes, shape))
    hits = sorted({n for n, ref in gathered
                   if not ref.expired() and ref.cdata not in known})
    del out
    measured = sum(packed.values()) + sum(b for b, _ in kept.values())
    # The arithmetic: the block input and cos/sin, and the outputs of the
    # policy's GEMMs at this rank's widths (wo's before its 'model' sum).
    tp = mesh.size(mesh_lib.MODEL_AXIS)
    hd = cfg.head_dim
    widths = {'wq': cfg.n_heads * hd // tp, 'wk': cfg.n_kv_heads * hd // tp,
              'wv': cfg.n_kv_heads * hd // tp, 'wo': cfg.dim,
              'w1': cfg.ffn_dim // tp, 'w3': cfg.ffn_dim // tp}
    elem = torch.empty((), dtype=cfg.dtype).element_size()
    computed = (rows * seq * elem * (cfg.dim + sum(
        widths[n] for n in llama.SAVED_GEMMS[cfg.remat_policy])) +
                2 * seq * (hd // 2) * 4)
    return dict(measured=measured, computed=computed, hits=hits,
                kept=sorted(shape for _, shape in kept.values()))


def saved_files(checkpoint, ckpt_dir, step):
    """(bytes on disk of each rank's file, the state's bytes from the
    index) of a sharded step directory."""
    import numpy as np
    import torch
    path = os.path.join(ckpt_dir, f'step_{step}')
    with open(os.path.join(path, checkpoint.INDEX_FILE),
              encoding='utf-8') as f:
        index = json.load(f)
    state = sum(int(np.prod(e['shape'])) *
                torch.empty((), dtype=getattr(torch, e['dtype'])
                            ).element_size()
                for e in index['leaves'].values())
    files = {name: os.path.getsize(os.path.join(path, name))
             for name in sorted(os.listdir(path)) if name.startswith('rank_')}
    return files, state


def shard_rank_runs(spec):
    """Rank function of (b)-(d), run by every rank of the phase's
    ``local_ranks``. For each run of ``spec['runs']``: the port's
    sharded trainer from the seed-0 state (``init_train_state(mesh=)``,
    each rank drawing leaf by leaf and keeping its slices) under the
    run's remat policy, ``steps`` steps of the global (data seed 0,
    step) batches, a checkpoint at ``save_at`` (its files' bytes read by
    rank 0); each step's loss, grad norm and seconds; with ``gather``
    the params after the last step gathered leaf by leaf to rank 0's
    host; with ``kept`` one block's kept bytes on every rank
    (``block_kept_bytes``); every rank's flash launches a step, seconds
    and peak memory. Returns rank 0's readings."""
    import torch
    from skypilot_tpu_torch.models import checkpoint, llama, train
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(spec['device'])
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**spec['mesh']))
    tc = train.TrainConfig(**spec['train'])
    out = []
    for run in spec['runs']:
        cfg = shard_config(llama, spec['model'], run['dtype'],
                           run['layers'], run['policy'])
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train.init_train_state(cfg, tc, dev, mesh)
        _sync(torch, dev)
        init_s = time.perf_counter() - t0
        step = train.make_train_step(cfg, tc, mesh)
        losses, norms, secs, grew = [], [], [], []
        save_s, files = None, None
        for i in range(run['steps']):
            tokens, targets = train.synthetic_batch(
                cfg.vocab_size, spec['batch'], spec['seq'], 0, i)
            before = [fn.launches for fn in fa.KERNELS]
            _sync(torch, dev)
            t0 = time.perf_counter()
            state, metrics = step(state, tokens, targets)
            losses.append(float(metrics['loss']))
            norms.append(float(metrics['grad_norm']))
            _sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            grew.append([fn.launches - n
                         for fn, n in zip(fa.KERNELS, before)])
            if run.get('save_at') == i + 1:
                t0 = time.perf_counter()
                checkpoint.save(spec['ckpt_dir'], state, i + 1, keep=1,
                                mesh=mesh)
                save_s = time.perf_counter() - t0
                if mesh.rank == 0:
                    files = saved_files(checkpoint, spec['ckpt_dir'], i + 1)
        peak = (torch.cuda.max_memory_allocated() if dev.type == 'cuda'
                else float('nan'))
        kept = (block_kept_bytes(torch, llama, cfg, state, mesh,
                                 spec['batch'] // mesh.size(
                                     mesh_lib.BATCH_AXES),
                                 spec['seq'], dev)
                if run.get('kept') else None)
        params = (train.tree_leaves(train.gather_tree(state.params, mesh))
                  if run.get('gather') else None)
        ranks = [None] * mesh.num_ranks
        torch.distributed.all_gather_object(ranks, dict(
            launches=grew, secs=secs, init_s=init_s, peak_bytes=peak,
            save_s=save_s, kept=kept))
        out.append(dict(label=run['label'], losses=losses, norms=norms,
                        params=params, ranks=ranks, save_s=save_s,
                        files=files, layers=cfg.n_layers))
        del state, step, params
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    return dict(runs=out, resnet=resnet_dp_steps(spec['resnet']))


def shard_control(torch, llama, train, dtype_name, layers):
    """The one-rank control of a run: the port's unsharded trainer from
    the same seed-0 state on the same batches. Returns its losses, grad
    norms, step seconds, and its initial and final params (host
    copies)."""
    dev = torch.device(DEVICE)
    cfg = shard_config(llama, TRAIN_MODEL, dtype_name, layers)
    state = train.init_train_state(cfg, train.TrainConfig(**SHARD_TRAIN),
                                   dev)
    first = [p.to('cpu', copy=True)
             for p in train.tree_leaves(state.params)]
    step = train.make_train_step(cfg, train.TrainConfig(**SHARD_TRAIN))
    losses, norms, secs = [], [], []
    for i in range(SHARD_STEPS):
        tokens, targets = train.synthetic_batch(cfg.vocab_size, SHARD_B,
                                                TRAIN_S, 0, i)
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics['loss']))
        norms.append(float(metrics['grad_norm']))
        sync(torch)
        secs.append(time.perf_counter() - t0)
    last = [p.to('cpu', copy=True) for p in train.tree_leaves(state.params)]
    del state, step
    empty_cache(torch)
    return dict(losses=losses, norms=norms, secs=secs, first=first,
                last=last)


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def params_distance(torch, got, want, first):
    """(||got - want|| / ||want - first|| over every leaf, max |got -
    want|), in fp32 on DEVICE leaf by leaf."""
    dev = torch.device(DEVICE)
    diff2 = move2 = worst = 0.0
    for g, w, f in zip(got, want, first):
        g, w, f = (t.to(dev).float() for t in (g, w, f))
        diff2 += (g - w).square().sum().item()
        move2 += (w - f).square().sum().item()
        worst = max(worst, (g - w).abs().max().item())
    return (math.sqrt(diff2 / move2) if move2 else float('inf')), worst


def shard_compare(torch, run, control, dtype_name, card):
    """A sharded run against its control under SHARD_TOL; prints both
    and returns the worst relative readings."""
    tol = SHARD_TOL[dtype_name]
    loss_rel = [rel_diff(a, b) for a, b in zip(run['losses'],
                                               control['losses'])]
    norm_rel = [rel_diff(a, b) for a, b in zip(run['norms'],
                                               control['norms'])]
    worst = dict(loss=max(loss_rel), grad_norm=max(norm_rel))
    params = '(params not gathered)'
    if run['params'] is not None:
        worst['params'], params_max = params_distance(
            torch, run['params'], control['last'], control['first'])
        params = (f'params after step {SHARD_STEPS}: ||p - p_control|| / '
                  f'||p_control - p_0|| {worst["params"]:.4e} (tol '
                  f'{tol["params"]}), max |p - p_control| '
                  f'{params_max:.4e}')
    print(f'[phase 19] {run["label"]}: losses {run["losses"]} against the '
          f'one-rank control\'s {control["losses"]} (rel {loss_rel}, tol '
          f'{tol["loss"]}); grad norms {run["norms"]} against '
          f'{control["norms"]} (rel {norm_rel}, tol {tol["grad_norm"]}); '
          f'{params}; on {card}', flush=True)
    for key, value in worst.items():
        if not value <= tol[key]:
            fail(f'phase 19 {run["label"]}: {key} {value} > {tol[key]}')
    return worst


def shard_ranks_report(run, expect_per_step, control_secs):
    """Print each rank's launches, step seconds and peak memory; fail
    unless every rank launched the flash kernels exactly
    ``expect_per_step`` a step."""
    for r, rank in enumerate(run['ranks']):
        print(f'[phase 19] {run["label"]} rank {r}: launches a step '
              f'{rank["launches"]}, step seconds '
              f'{[round(s, 3) for s in rank["secs"]]} (init '
              f'{rank["init_s"]:.1f}s), peak {rank["peak_bytes"] / 2**30:.2f}'
              f' GiB (max_memory_allocated)', flush=True)
        if any(g != expect_per_step for g in rank['launches']):
            fail(f'phase 19 {run["label"]} rank {r}: flash launches '
                 f'{rank["launches"]}, expected {expect_per_step} a step')
    secs = run['ranks'][0]['secs']
    step_s = statistics.median(secs[1:] or secs)
    print(f'[phase 19] {run["label"]}: a step {step_s:.3f}s on four ranks '
          f'(gloo through the host) against '
          f'{statistics.median(control_secs[1:]):.3f}s on one', flush=True)


def resnet_dp_steps(spec):
    """(e), run by every rank of the phase's ``local_ranks`` after
    (b)-(c): ResNet-50 momentum SGD over a 'data' mesh of the first
    ``spec['ranks']`` ranks (the others idle), from the seed-0 params on
    phase 14's batch (every rank draws the same global batch and keeps
    its rows). Returns rank 0's losses and each mesh rank's step seconds
    and peak memory."""
    import torch
    from skypilot_tpu_torch.models import resnet
    dev = torch.device(spec['device'])
    torch.backends.cudnn.allow_tf32 = False
    mesh = resnet.data_mesh(range(spec['ranks']))
    losses, mine = [], None
    if mesh is not None:
        cfg = resnet.CONFIGS[spec['model']]
        params, momentum, images, labels = resnet_batch(
            torch, resnet, cfg, dev, spec['batch'], spec['size'])
        step = resnet.make_train_step(cfg, lr=spec['lr'], mesh=mesh)
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(spec['steps']):
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, momentum, loss = step(params, momentum, images, labels)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        mine = dict(secs=secs, peak_bytes=(
            torch.cuda.max_memory_allocated() if dev.type == 'cuda'
            else float('nan')))
        del params, momentum, images, labels, step
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    return dict(losses=losses, ranks=ranks[:spec['ranks']])


def resnet_batch(torch, resnet, cfg, dev, batch, size):
    """Phase 14's ResNet state and batch: params from seed 0, then the
    images and labels from the same generator; the second half of the
    images scaled and shifted (RESNET_DP_SKEW), so the rows of rank 0
    and rank 1 differ in their statistics."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = resnet.init_params(cfg, gen, dev)
    images = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    scale, shift = RESNET_DP_SKEW
    images[batch // 2:] = images[batch // 2:] * scale + shift
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=dev)
    return params, resnet.zeros_momentum(params), images, labels


def resnet_dp_control(torch, card, got):
    """(e) checked: the ranks' ResNet-50 losses (``resnet_dp_steps``)
    against a one-rank control on the same params and batch."""
    from skypilot_tpu_torch.models import resnet
    dev = torch.device(DEVICE)
    cfg = resnet.CONFIGS[RESNET_MODEL]
    params, momentum, images, labels = resnet_batch(torch, resnet, cfg, dev,
                                                    RESNET_B, RESNET_SIZE)
    step = resnet.make_train_step(cfg, lr=RESNET_LR)
    control = []
    for _ in range(RESNET_DP_STEPS):
        params, momentum, loss = step(params, momentum, images, labels)
        control.append(float(loss))
    del params, momentum, images, labels, step
    empty_cache(torch)
    rels = [rel_diff(a, b) for a, b in zip(got['losses'], control)]
    print(f'[phase 19] (e) {RESNET_MODEL} {RESNET_SIZE}x{RESNET_SIZE} bf16, '
          f'global batch {RESNET_B} over {RESNET_DP_RANKS} ranks (sync BN): '
          f'losses {got["losses"]} against one rank\'s {control} (rel '
          f'{rels}, tol {RESNET_DP_TOL}); ' + '; '.join(
              f'rank {r} step seconds {[round(s, 3) for s in x["secs"]]}, '
              f'peak {x["peak_bytes"] / 2**30:.2f} GiB'
              for r, x in enumerate(got['ranks'])) + f'; on {card}',
          flush=True)
    if len(got['losses']) != RESNET_DP_STEPS or not max(rels) <= (
            RESNET_DP_TOL):
        fail(f'phase 19 (e): losses {got["losses"]} against {control}')
    return dict(losses=got['losses'], control=control, rel=max(rels))


def rank_devices(n):
    """local_ranks' placement: every rank on the one card over gloo, or
    CPU ranks in a rehearsal."""
    if DEVICE == 'cpu':
        return dict(platform='cpu')
    return dict(devices=['cuda:0'] * n, backend='gloo')


def same_steps(run, full, card):
    """A policy run's losses and grad norms against its 'full' run's
    first steps, bit for bit (a policy changes what backward keeps,
    never a value)."""
    n = len(run['losses'])
    same = (run['losses'] == full['losses'][:n] and
            run['norms'] == full['norms'][:n])
    print(f'[phase 19] {run["label"]} against {full["label"]}: losses '
          f'{run["losses"]} / {full["losses"][:n]}, grad norms '
          f'{run["norms"]} / {full["norms"][:n]}: '
          f'{"bit-equal" if same else "DIFFERENT"}; on {card}', flush=True)
    if not same:
        fail(f'phase 19 {run["label"]}: not bit-equal to {full["label"]}')


def kept_report(run, card):
    """(b'): each rank's kept bytes of one block against the arithmetic
    within SHARD_KEPT_REL_TOL, and no gathered weight kept. Returns the
    worst relative difference."""
    worst = 0.0
    for r, rank in enumerate(run['ranks']):
        kept = rank['kept']
        rel = abs(kept['measured'] - kept['computed']) / kept['computed']
        worst = max(worst, rel)
        print(f'[phase 19] {run["label"]} rank {r}: one block keeps '
              f'{kept["measured"]} bytes for its backward against '
              f'{kept["computed"]} at the rank\'s shard widths (rel '
              f'{rel:.3e}, tol {SHARD_KEPT_REL_TOL}); kept tensors '
              f'{kept["kept"]}; gathered weights still alive '
              f'{kept["hits"]}; on {card}', flush=True)
        if not rel <= SHARD_KEPT_REL_TOL or kept['hits']:
            fail(f'phase 19 {run["label"]} rank {r}: kept {kept}')
    return worst


def save_report(run, card):
    """(d): each rank's bytes on disk and their sum against the state's
    bytes (each slice written once), and the save's seconds."""
    files, state = run['files']
    total = sum(files.values())
    secs = [rank['save_s'] for rank in run['ranks']]
    print(f'[phase 19] (d) the step-{SHARD_SAVE_AT} sharded save: files '
          f'{files} bytes, sum {total} against the state\'s {state} '
          f'(params, mu, nu; ratio {total / state:.6f}, tol 1 + '
          f'{SHARD_SAVE_OVERHEAD}); seconds by rank '
          f'{[round(x, 2) for x in secs]}; on {card}', flush=True)
    if not state <= total <= state * (1 + SHARD_SAVE_OVERHEAD):
        fail(f'phase 19 (d): {total} bytes saved for a {state}-byte state')
    return dict(files=files, state=state, seconds=max(secs))


def shard_phase(torch, llama, train, fa, card):
    """Phase 19: the sharded trainer; (a) before, (b)-(e) after the
    launch counts are reset (they are read by the caller)."""
    from skypilot_tpu_torch.parallel import distributed
    t_start = time.perf_counter()
    kernels = (kernel_twin_check(torch, fa, SHARD_FLASH_CASE, 'phase 19', 19)
               if DEVICE == 'cuda' else {})
    controls = {'bf16': shard_control(torch, llama, train, 'bf16', None),
                'fp32': shard_control(torch, llama, train, 'fp32',
                                      SHARD_FP32_LAYERS)}
    t_controls = time.perf_counter()
    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    fp32 = f'{SHARD_FP32_LAYERS} layers fp32'
    runs = [dict(label="(b) bf16 'full'", dtype='bf16', layers=None,
                 policy='full', steps=SHARD_STEPS, save_at=SHARD_SAVE_AT,
                 gather=True),
            dict(label="(b') bf16 'dots'", dtype='bf16', layers=None,
                 policy='dots', steps=SHARD_DOTS_STEPS, kept=True),
            dict(label=f"(c) {fp32} 'full'", dtype='fp32',
                 layers=SHARD_FP32_LAYERS, policy='full', steps=SHARD_STEPS,
                 gather=True)]
    runs += [dict(label=f"(c') {fp32} {policy!r}", dtype='fp32',
                  layers=SHARD_FP32_LAYERS, policy=policy,
                  steps=SHARD_FP32_POLICY_STEPS)
             for policy in SHARD_FP32_POLICIES]
    spec = dict(device=DEVICE, model=TRAIN_MODEL, mesh=SHARD_MESH,
                train=SHARD_TRAIN, batch=SHARD_B, seq=TRAIN_S,
                ckpt_dir=SHARD_CKPT_DIR, runs=runs,
                resnet=dict(device=DEVICE, ranks=RESNET_DP_RANKS,
                            model=RESNET_MODEL, batch=RESNET_B,
                            size=RESNET_SIZE, lr=RESNET_LR,
                            steps=RESNET_DP_STEPS))
    fa.reset_launch_counts()
    ranked = distributed.local_ranks(SHARD_RANKS, shard_rank_runs, (spec,),
                                     **rank_devices(SHARD_RANKS))
    counts = {fn.__name__: fn.launches for fn in fa.KERNELS}
    done = {run['label']: run for run in ranked['runs']}
    t_ranks = time.perf_counter()
    report = {}
    for run, want in zip(ranked['runs'], runs):
        control = controls[want['dtype']]
        layers = run['layers']
        shard_ranks_report(run, [2 * layers, layers, layers],
                           control['secs'])
        report[run['label']] = shard_compare(torch, run, control,
                                             want['dtype'], card)
        if want['policy'] != 'full':
            full = done[runs[0 if want['dtype'] == 'bf16' else 2]['label']]
            same_steps(run, full, card)
        if want.get('kept'):
            report['kept'] = kept_report(run, card)
    full_b = ranked['runs'][0]
    step1 = rel_diff(full_b['losses'][0], controls['bf16']['losses'][0])
    print(f'[phase 19] (b) step-1 loss rel {step1:.3e} (the reference\'s '
          f'rtol {SHARD_STEP1_RTOL})', flush=True)
    if not step1 <= SHARD_STEP1_RTOL:
        fail(f'phase 19 (b): step-1 loss {full_b["losses"][0]} against '
             f'{controls["bf16"]["losses"][0]}')
    report['save'] = save_report(full_b, card)
    # (d) One rank resumes the four-rank checkpoint.
    resumed = {}
    t0 = time.perf_counter()
    end = train.train_loop(
        shard_config(llama, TRAIN_MODEL, 'bf16'),
        train.TrainConfig(**SHARD_TRAIN), SHARD_STEPS, SHARD_B, TRAIN_S,
        checkpoint_dir=SHARD_CKPT_DIR, save_every=SHARD_STEPS, keep=1,
        log_every=0, device=torch.device(DEVICE),
        on_step=lambda i, m: resumed.__setitem__(i, float(m['loss'])))
    del end
    empty_cache(torch)
    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    want = full_b['losses'][SHARD_STEPS - 1]
    got = resumed.get(SHARD_STEPS)
    resume_rel = rel_diff(got, want) if got is not None else float('inf')
    print(f'[phase 19] (d) one rank resumed the four-rank step-'
          f'{SHARD_SAVE_AT} checkpoint: steps {sorted(resumed)}, step-'
          f'{SHARD_STEPS} loss {got} against the four ranks\' {want} (rel '
          f'{resume_rel:.3e}, tol {SHARD_TOL["bf16"]["loss"]}) in '
          f'{time.perf_counter() - t0:.1f}s', flush=True)
    if sorted(resumed) != [SHARD_STEPS] or not (
            resume_rel <= SHARD_TOL['bf16']['loss']):
        fail(f'phase 19 (d): resumed {resumed}, four ranks {want}')
    t_resume = time.perf_counter()
    report['resnet'] = resnet_dp_control(torch, card, ranked['resnet'])
    print(f'[time] phase 19: kernels and controls '
          f'{t_controls - t_start:.1f}s, four ranks (with (e)) '
          f'{t_ranks - t_controls:.1f}s, resume {t_resume - t_ranks:.1f}s, '
          f'resnet control {time.perf_counter() - t_resume:.1f}s',
          flush=True)
    report.update(kernels=kernels, step1=step1, resume=resume_rel)
    return counts, report


# -------------------------------------------------------------- phase 20

# (a) mixtral-8x7b at its full width (dim 4096, 32 heads, 8 KV heads,
# ffn 14336, 8 experts, top-2, vocab 128256), cut to 2 of its 32 layers:
# its 46.7B params are 93 GB in bf16, past one 80 GB card; at 2 layers
# 3.95B (about 32 GB with grads and bf16 moments). bf16, flash, remat.
MOE_MODEL, MOE_LAYERS = 'mixtral-8x7b', 2
MOE_B, MOE_S, MOE_STEPS = 2, 2048, 2
MOE_FP32_LAYERS = 1
MOE_TRAIN = dict(learning_rate=3e-4, warmup_steps=1)
# The kernel path's loss against impl='plain''s, relative, at phase 8's
# bf16 bound. Routing is discrete: left to route on its own, the kernel
# path sends some tokens to other experts than the plain path does (the
# attention's bf16 differences; each moved token's FFN output changes
# whole: 26 and 67 of 4,096 tokens, loss rel 1.800e-4 on an H100, 700
# W). So the kernel path is held to the plain one with the plain pass's
# top-k choices fed back in (its own gates), and the kernel step's
# step-1 loss to the kernel path's own no-grad loss.
MOE_PLAIN_LOSS_TOL = TRAIN_E2E_TOL['bf16']['loss']
# Kernels 4-6 against their twins at the attention shape of (a):
# (B, S, H, Hkv, D, causal), a GQA group of 4.
MOE_FLASH_CASE = (MOE_B, MOE_S, 32, 8, 128, True)
# Four ranks sharing the card over gloo on (expert 2, model 2): each
# holds 4 of the 8 experts, each expert's ffn dim split in two (and
# attention's heads, the vocab); (expert 2) on two ranks before the
# model axis inside the experts was ported.
MOE_MESH, MOE_RANKS = dict(fsdp=1, expert=2, model=2), 4
# (b) GPipe: bench-1b at full width and depth (TRAIN_MODEL as phase 19
# trains it), 4 microbatches of 1 x 2048, over (stage 2) and (stage 4)
# on the card; fp32 at 4 layers over (stage 2).
PP_STAGES = (2, 4)
PP_MICRO, PP_STEPS, PP_FP32_LAYERS = 4, 2, 4
# (c) Ring attention at llama3-8b's attention widths, (B, S, H, Hkv, D),
# over a 'seq' axis of 4 ranks.
RING_CASE = (1, 8192, 32, 8, 128)
RING_RANKS = 4
# The bf16 ring and the flash kernel against the plain twin at
# RING_CASE: twin_error's rule (rtol one ulp, norm 5e-3), each output
# with its own per-element atol, dq's first RING_LEAD_ROWS query rows
# apart from the rest. The ring (the reference's algorithm) rounds P to
# bf16 a block at a time against a running max and its backward takes
# the cast as identity, so in the first rows, whose exact dq nearly
# cancels, the rounding stays: the reference's own bf16 ring needs
# 0.3037 x the row scale at dq's row 1 on the CPU test's shape, as the
# port's does. Readings on an H100 (700 W), by output: the ring's out
# 8.9e-3, dq 0.611 at row 1 and 3.624e-2 past row 16 (rising with the
# row, 2.0e-2 in rows 16-32), dk 5.29e-2, dv 1.64e-2; the kernel's dq
# 4.585e-2 at row 1 and 1.01e-2 past row 16, the rest <= 1.17e-2.
# FLASH_BF16_TOL's 2e-2 where a reading is inside it, else about twice
# the reading (PERF.md section 6, PR 19).
RING_LEAD_ROWS = 16
RING_ATOL = {'ring': {'out': 2e-2, 'dq': 0.075, 'dq lead': 1.25, 'dk': 0.1,
                      'dv': 2e-2},
             'kernel': {'out': 2e-2, 'dq': 2e-2, 'dq lead': 0.1,
                        'dk': 2e-2, 'dv': 2e-2}}
# The ranks of (a)-(c) in one launch, and the settings they read (a
# rehearsal on the CPU changes them in its own process only).
PHASE20_RANKS = 4
PHASE20_SETTINGS = ('DEVICE', 'MOE_MODEL', 'MOE_LAYERS', 'MOE_B', 'MOE_S',
                    'MOE_STEPS', 'MOE_TRAIN', 'MOE_MESH', 'MOE_RANKS',
                    'PP_STAGES', 'PP_MICRO', 'PP_STEPS', 'PP_FP32_LAYERS',
                    'RING_CASE', 'RING_RANKS', 'TRAIN_MODEL', 'TRAIN_S',
                    'SHARD_TRAIN')


def moe_config(moe, dtype_name, layers):
    """mixtral-8x7b at ``layers`` layers, flash and remat, in
    ``dtype_name``."""
    import dataclasses
    import torch
    return dataclasses.replace(
        moe.CONFIGS[MOE_MODEL], n_layers=layers, flash_attention=True,
        remat=True, dtype=torch.bfloat16 if dtype_name == 'bf16'
        else torch.float32)


def timed_steps(torch, fa, dev, state, step, batches):
    """``step`` over ``batches`` from ``state``: each step's loss, grad
    norm, seconds and flash launches, and the peak memory since the
    caller reset it."""
    out = dict(losses=[], norms=[], secs=[], launches=[])
    for tokens, targets in batches:
        before = [fn.launches for fn in fa.KERNELS]
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, targets)
        out['losses'].append(float(metrics['loss']))
        out['norms'].append(float(metrics['grad_norm']))
        _sync(torch, dev)
        out['secs'].append(time.perf_counter() - t0)
        out['launches'].append([fn.launches - n
                                for fn, n in zip(fa.KERNELS, before)])
    out['peak_bytes'] = (torch.cuda.max_memory_allocated()
                         if dev.type == 'cuda' else float('nan'))
    return out


def moe_batches(train, cfg, steps):
    return [train.synthetic_batch(cfg.vocab_size, MOE_B, MOE_S, 0, i)
            for i in range(steps)]


def pp_batches(train, cfg):
    return [train.synthetic_batch(cfg.vocab_size, PP_MICRO, TRAIN_S, 0, i)
            for i in range(PP_STEPS)]


def ring_inputs(torch, dtype, dev):
    """q, k, v and the output's cotangent g at RING_CASE, from seed 20."""
    b, s, h, hkv, d = RING_CASE
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, h, d))]


def phase20_ranks(settings):
    """Rank function of phase 20, run by every rank of one
    ``local_ranks`` with the caller's ``settings``: (a) the MoE trainer
    on MOE_MESH over the first MOE_RANKS ranks (first step 1's loss and
    grad norm with the 'model' part of the experts' sum left out), (b)
    the GPipe steps over (stage 2) on ranks 0-1 and (stage 4) on all,
    (c) ring attention over a (seq 4) mesh, forward and backward.
    Returns rank 0's readings with every rank's launches,
    seconds and peak memory."""
    globals().update(settings)
    import torch
    from skypilot_tpu_torch.models import llama, moe, train
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline, ring
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    mine = {}

    def reset_peak():
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # (a) MoE over ('expert', 'model'): first the step-1 loss and grad
    # norm with the 'model' part of the experts' sum left out (no update,
    # so the same state then trains), then the steps.
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**MOE_MESH),
                              ranks=range(MOE_RANKS))
    tc = train.TrainConfig(**MOE_TRAIN)
    cfg = moe_config(moe, 'bf16', MOE_LAYERS)
    if mesh is not None:
        reset_peak()
        t0 = time.perf_counter()
        state = train.init_train_state(cfg, tc, dev, mesh)
        _sync(torch, dev)
        init_s = time.perf_counter() - t0
        expert_sum = moe._expert_sum  # pylint: disable=protected-access
        moe._expert_sum = lambda out, mesh: mesh_lib.reduce_from(  # pylint: disable=protected-access
            out, mesh, mesh_lib.EXPERT_AXIS)
        try:
            tokens, targets = (torch.from_numpy(a[mesh.batch_rows(
                len(a))]).to(dev) for a in moe_batches(train, cfg, 1)[0])
            _sync(torch, dev)
            t0 = time.perf_counter()
            loss, grads = train.value_and_grad(state.params, tokens,
                                               targets, cfg, mesh)
            norm = train.global_norm(grads, mesh,
                                     moe.param_partition_specs(cfg))
            mine['moe no model sum'] = dict(
                losses=[float(loss)], norms=[float(norm)],
                secs=[time.perf_counter() - t0],
                peak_bytes=(torch.cuda.max_memory_allocated()
                            if dev.type == 'cuda' else float('nan')))
            del loss, grads, norm, tokens, targets
        finally:
            moe._expert_sum = expert_sum  # pylint: disable=protected-access
        reset_peak()
        mine['moe'] = timed_steps(
            torch, fa, dev, state, train.make_train_step(cfg, tc, mesh),
            moe_batches(train, cfg, MOE_STEPS))
        mine['moe']['init_s'] = init_s
        mine['moe']['local_we1'] = list(state.params['layers']['we1'].shape)
        del state
    # (b) GPipe.
    tc = train.TrainConfig(**SHARD_TRAIN)
    for stages, dtype_name, layers in ((PP_STAGES[0], 'bf16', None),
                                       (PP_STAGES[0], 'fp32',
                                        PP_FP32_LAYERS),
                                       (PP_STAGES[1], 'bf16', None)):
        label = f'gpipe stage {stages} {dtype_name}'
        cfg = shard_config(llama, TRAIN_MODEL, dtype_name, layers)
        mesh = pipeline.make_pp_mesh(stages, 1, ranks=range(stages))
        if mesh is None:
            continue
        reset_peak()
        state = pipeline.init_pp_train_state(cfg, tc, mesh, dev)
        mine[label] = timed_steps(
            torch, fa, dev, state,
            pipeline.make_pp_train_step(cfg, tc, mesh, PP_MICRO),
            pp_batches(train, cfg))
        mine[label]['layers'] = int(state.params['layers']['wq'].shape[0])
        del state
    # (c) Ring attention over 'seq'.
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(fsdp=1, seq=RING_RANKS))
    rank0 = {}
    for dtype_name, dtype in (('bf16', torch.bfloat16),
                              ('fp32', torch.float32)):
        reset_peak()
        q, k, v, g = ring_inputs(torch, dtype, dev)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = ring.ring_attention(q, k, v, mesh)
        grads = torch.autograd.grad(out, (q, k, v), g)
        _sync(torch, dev)
        mine[f'ring {dtype_name}'] = dict(
            secs=[time.perf_counter() - t0],
            peak_bytes=(torch.cuda.max_memory_allocated()
                        if dev.type == 'cuda' else float('nan')))
        if mesh.rank == 0:
            rank0[dtype_name] = [out.detach()] + list(grads)
        del q, k, v, g, out, grads
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, mine)
    return dict(ranks=ranks, ring=rank0)


def pp_control(torch, llama, train, fa, dtype_name, layers):
    """(b)'s one-rank control: the unsharded ``make_train_step`` from the
    same seed-0 params on the same global batches."""
    dev = torch.device(DEVICE)
    cfg = shard_config(llama, TRAIN_MODEL, dtype_name, layers)
    tc = train.TrainConfig(**SHARD_TRAIN)
    run = timed_steps(torch, fa, dev, train.init_train_state(cfg, tc, dev),
                      train.make_train_step(cfg, tc), pp_batches(train, cfg))
    empty_cache(torch)
    return run


def moe_control(torch, moe, train, fa, card):
    """(a) on one rank: on the seed-0 params (no grad) the plain-attention
    loss, the kernel loss, and the kernel loss with the plain pass's
    top-k choices fed back in, with the routing flips between the two
    free passes; then the flash launch counts reset and MOE_STEPS kernel
    steps with their launches checked. Returns the steps' readings."""
    dev = torch.device(DEVICE)
    cfg = moe_config(moe, 'bf16', MOE_LAYERS)
    tc = train.TrainConfig(**MOE_TRAIN)
    empty_cache(torch)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train.init_train_state(cfg, tc, dev)
    sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in train.tree_leaves(state.params))
    tokens, targets = (torch.from_numpy(a).to(dev)
                       for a in moe_batches(train, cfg, 1)[0])
    # Each layer's top-k choices, in top-k order, under each pass.
    choices = {'plain': [], 'kernel': [], 'routed as plain': []}
    assign, topk = moe._assign, torch.topk  # pylint: disable=protected-access

    def recorded(impl):
        def wrapped(probs, c):
            choices[impl].append(topk(probs, c.top_k).indices)
            return assign(probs, c)
        return wrapped

    def routed_as_plain(probs, c):
        idx = choices['plain'][len(choices['routed as plain'])]
        choices['routed as plain'].append(idx)
        # The plain pass's experts, in its order, at this pass's gates.
        torch.topk = lambda p, k, dim=-1: (p.gather(-1, idx), idx)
        try:
            return assign(probs, c)
        finally:
            torch.topk = topk

    losses = {}
    for label, impl, wrapper in (
            ('plain', 'plain', recorded('plain')),
            ('kernel', 'kernel', recorded('kernel')),
            ('routed as plain', 'kernel', routed_as_plain)):
        moe._assign = wrapper  # pylint: disable=protected-access
        try:
            with torch.no_grad():
                losses[label] = float(moe.loss_fn(state.params, tokens,
                                                  targets, cfg, impl=impl))
        finally:
            moe._assign = assign  # pylint: disable=protected-access
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(choices['plain'], choices['kernel'])]
    del tokens, targets, choices
    fa.reset_launch_counts()  # the main path's launches from here
    run = timed_steps(torch, fa, dev, state,
                      train.make_train_step(cfg, tc),
                      moe_batches(train, cfg, MOE_STEPS))
    del state
    empty_cache(torch)
    expect = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    rel = rel_diff(losses['routed as plain'], losses['plain'])
    free_rel = rel_diff(losses['kernel'], losses['plain'])
    step_rel = rel_diff(run['losses'][0], losses['kernel'])
    print(f'[phase 20] (a) {MOE_MODEL} at {MOE_LAYERS} layers '
          f'({n_params / 1e9:.2f}B params, bf16, flash, remat, batch '
          f'{MOE_B} x {MOE_S}) on one rank: init {init_s:.1f}s; losses '
          f'{run["losses"]}, grad norms {run["norms"]}, step seconds '
          f'{[round(s, 3) for s in run["secs"]]}, launches a step '
          f'{run["launches"]} (expected {expect}: forward and recompute '
          f'2L, dq and dk/dv L), peak {run["peak_bytes"] / 2**30:.2f} GiB; '
          f'no-grad losses {losses}: kernel routed as plain against plain '
          f'rel {rel:.3e}, the kernel step\'s step-1 loss against the '
          f'no-grad kernel loss rel {step_rel:.3e} (tol '
          f'{MOE_PLAIN_LOSS_TOL} each); kernel routed on its own against '
          f'plain rel {free_rel:.3e} (no bound), tokens whose experts '
          f'differ between those two, by layer: {flips} of '
          f'{MOE_B * MOE_S}; on {card}', flush=True)
    if any(g != expect for g in run['launches']):
        fail(f'phase 20 (a): flash launches {run["launches"]}, expected '
             f'{expect} a step')
    if not all(math.isfinite(x) for x in run['losses'] + run['norms']):
        fail(f'phase 20 (a): non-finite readings {run}')
    if not (rel <= MOE_PLAIN_LOSS_TOL and step_rel <= MOE_PLAIN_LOSS_TOL):
        fail(f'phase 20 (a): no-grad losses {losses}, the kernel step\'s '
             f'{run["losses"][0]}')
    return run


def moe_fp32_check(torch, moe, card):
    """(a) fp32 at MOE_FP32_LAYERS layers: logits and aux of the kernel
    path against the plain path, relative to the largest |logit|."""
    dev = torch.device(DEVICE)
    cfg = moe_config(moe, 'fp32', MOE_FP32_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = moe.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_S),
                           generator=gen, device=dev)
    with torch.no_grad():
        got, got_aux = moe.forward(params, tokens, cfg, impl='kernel')
        want, want_aux = moe.forward(params, tokens, cfg, impl='plain')
        rel = ((got - want).abs().max() / want.abs().max()).item()
    del params, got, want
    empty_cache(torch)
    aux_rel = rel_diff(float(got_aux), float(want_aux))
    print(f'[phase 20] (a) fp32 at {MOE_FP32_LAYERS} layer(s): max |dlogit| '
          f'/ max |logit| kernel against plain {rel:.3e}, aux rel '
          f'{aux_rel:.3e} (tol {FLASH_FP32_REL_TOL}); on {card}', flush=True)
    if not (rel <= FLASH_FP32_REL_TOL and aux_rel <= FLASH_FP32_REL_TOL):
        fail(f'phase 20 (a) fp32: logits rel {rel}, aux rel {aux_rel}')
    return rel


def report_ranks(label, ranks, expect=None):
    """Print each rank's launches a step, step seconds and peak memory
    for ``label``; fail unless each rank that ran it launched the flash
    kernels ``expect`` a step."""
    for r, mine in enumerate(ranks):
        run = mine.get(label)
        if run is None:
            continue
        print(f'[phase 20] {label} rank {r}: launches a step '
              f'{run.get("launches")}, seconds '
              f'{[round(s, 3) for s in run["secs"]]}, peak '
              f'{run["peak_bytes"] / 2**30:.2f} GiB (max_memory_allocated)',
              flush=True)
        if expect is not None and any(g != expect for g in run['launches']):
            fail(f'phase 20 {label} rank {r}: flash launches '
                 f'{run["launches"]}, expected {expect} a step')


def check_against(label, run, control, tol, steps, card):
    """Losses and grad norms of ``run`` against ``control`` over
    ``steps`` steps under ``tol``; returns the worst relative readings."""
    loss = max(rel_diff(a, b) for a, b in zip(run['losses'][:steps],
                                              control['losses']))
    norm = max(rel_diff(a, b) for a, b in zip(run['norms'][:steps],
                                              control['norms']))
    print(f'[phase 20] {label}: losses {run["losses"]} against the '
          f'one-rank control\'s {control["losses"][:steps]} (worst rel '
          f'{loss:.3e}, tol {tol["loss"]}); grad norms {run["norms"]} '
          f'against {control["norms"][:steps]} (worst rel {norm:.3e}, tol '
          f'{tol["grad_norm"]}); on {card}', flush=True)
    return dict(loss=loss, grad_norm=norm)


def within(worst, tol):
    return all(worst[k] <= tol[k] for k in worst)


def plain_by_kv_head(torch, fa, q, k, v, g):
    """The plain twin's output and dq/dk/dv at RING_CASE, a KV head (and
    its query group) at a time, so no [S, S] score tensor holds every
    head at once."""
    hkv = k.shape[2]
    group = q.shape[2] // hkv
    want = [torch.empty_like(t) for t in (q, q, k, v)]
    for j in range(hkv):
        heads = slice(j * group, (j + 1) * group)
        sub = (q[:, :, heads], k[:, :, j:j + 1], v[:, :, j:j + 1])
        out, lse = fa.flash_forward_plain(*sub, True)
        dq, dk, dv = fa.flash_backward_plain(*sub, out, lse, g[:, :, heads],
                                             True)
        want[0][:, :, heads] = out
        want[1][:, :, heads] = dq
        want[2][:, :, j:j + 1] = dk
        want[3][:, :, j:j + 1] = dv
    return want


def worst_position(need):
    """(b, s, h) of the element of ``need`` [B, S, H, D] that needs the
    largest atol."""
    flat = int(need.reshape(-1).argmax())
    b, s, h, d = need.shape
    return (flat // (s * h * d), flat // (h * d) % s, flat // d % h)


def ring_bf16_check(what, got, twin, atol):
    """One bf16 output of (c) (the ring's or the kernel's) against the
    plain twin: per element under ``atol[what]`` (dq's first
    RING_LEAD_ROWS rows under ``atol['dq lead']``), in norm under
    FLASH_BF16_TOL's. Returns (failures, a report line with the needs by
    sequence-row band and the worst element's position)."""
    need = atol_need(got, twin, FLASH_BF16_TOL['rtol'])
    by_row = need.amax(dim=(0, 2, 3))
    lead, rest = (by_row[:RING_LEAD_ROWS].max().item(),
                  by_row[RING_LEAD_ROWS:].max().item())
    bounds = ((atol['dq lead'], atol['dq']) if what == 'dq'
              else (atol[what], atol[what]))
    fro = ((got.float() - twin.float()).norm() / twin.float().norm()).item()
    edges = [0] + [2**i for i in range(int(math.log2(by_row.numel())) + 1)]
    bands = {f'{a}-{b}': round(by_row[a:b].max().item(), 4)
             for a, b in zip(edges, edges[1:])}
    failures = []
    if not (lead <= bounds[0] and rest <= bounds[1]):
        failures.append(f'{what}: rows < {RING_LEAD_ROWS} need {lead:.3e} '
                        f'(tol {bounds[0]}), the rest {rest:.3e} (tol '
                        f'{bounds[1]})')
    if not fro <= FLASH_BF16_TOL['fro']:
        failures.append(f'{what}: ||d||/||twin|| {fro}')
    return failures, (
        f'per element needs atol {lead:.3e} x row scale in sequence rows < '
        f'{RING_LEAD_ROWS} (tol {bounds[0]}), {rest:.3e} in the rest (tol '
        f'{bounds[1]}); ||d||/||twin|| {fro:.3e} (tol '
        f'{FLASH_BF16_TOL["fro"]}); worst element at (b, s, h) '
        f'{worst_position(need)}; needs by sequence-row band {bands}')


def ring_check(torch, fa, got, card):
    """(c) The ring's global output and dq/dk/dv against the plain twin
    on the whole sequence (computed a KV head at a time; fp32 arithmetic
    on the same inputs): fp32 under ``twin_error``'s bound, as phase 6
    holds the flash kernel; bf16 under ``RING_ATOL['ring']``, the flash
    kernel on the same inputs under ``RING_ATOL['kernel']``, and the ring
    against the kernel in relative norm within twice the twin bound (each
    of the two within it of the twin). Prints every reading before
    failing."""
    dev = torch.device(DEVICE)
    b, s, h, hkv, d = RING_CASE
    worst, failures = {}, []
    for dtype_name, dtype in (('bf16', torch.bfloat16),
                              ('fp32', torch.float32)):
        q, k, v, g = ring_inputs(torch, dtype, dev)
        twin = plain_by_kv_head(torch, fa, q, k, v, g)
        kernel = None
        if dtype_name == 'bf16':
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            out = fa.flash_attention(q, k, v, True, 'kernel')
            kernel = [out.detach()] + list(torch.autograd.grad(
                out, (q, k, v), g))
            del out
        for i, what in enumerate(('out', 'dq', 'dk', 'dv')):
            x = got[dtype_name][i]
            if x.shape != twin[i].shape or x.dtype != dtype or (
                    not torch.isfinite(x).all()):
                failures.append(f'ring {dtype_name} {what}: bad output')
                continue
            if kernel is None:
                err, msg = twin_error(x, twin[i], dtype_name)
                failures += [f'ring {dtype_name} {what}: {err}'] if err else []
                print(f'[phase 20] (c) ring {dtype_name} {what} against the '
                      f'plain twin: {msg}', flush=True)
            else:
                for who, y in (('ring', x), ('kernel', kernel[i])):
                    bad, msg = ring_bf16_check(what, y, twin[i],
                                               RING_ATOL[who])
                    failures += [f'{who} bf16 {m}' for m in bad]
                    print(f'[phase 20] (c) {who} bf16 {what} against the '
                          f'plain twin: {msg}', flush=True)
                fro = ((x.float() - kernel[i].float()).norm() /
                       kernel[i].float().norm()).item()
                print(f'[phase 20] (c) ring bf16 {what} against the kernel: '
                      f'||d||/||kernel|| {fro:.3e} (tol '
                      f'{2 * FLASH_BF16_TOL["fro"]})', flush=True)
                if not fro <= 2 * FLASH_BF16_TOL['fro']:
                    failures.append(f'ring bf16 {what} against the kernel: '
                                    f'{fro}')
            worst[f'{dtype_name} {what}'] = (x.float() - twin[i].float()
                                             ).abs().max().item()
        del q, k, v, g, twin, kernel
        empty_cache(torch)
    print(f'[phase 20] (c) ring attention B {b}, S {s}, H {h}, Hkv {hkv}, '
          f'D {d} over a seq axis of {RING_RANKS}: max abs errors against '
          f'the twin {worst}; on {card}', flush=True)
    if failures:
        fail(f'phase 20 (c): {failures}')
    return worst


def moe_pp_ring_phase(torch, llama, train, fa, card):
    """Phase 20: MoE, GPipe and ring attention. The one-rank controls run
    first; the flash launch counts are reset before (a)'s one-rank steps
    (``moe_control``) and read after the ranks' run, before the
    kernel-against-plain checks. Returns (counts, report)."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.parallel import distributed
    t_start = time.perf_counter()
    pp_controls = {'bf16': pp_control(torch, llama, train, fa, 'bf16',
                                      None),
                   'fp32': pp_control(torch, llama, train, fa, 'fp32',
                                      PP_FP32_LAYERS)}
    t_controls = time.perf_counter()
    moe_run = moe_control(torch, moe, train, fa, card)
    t_moe = time.perf_counter()
    settings = {name: globals()[name] for name in PHASE20_SETTINGS}
    ranked = distributed.local_ranks(PHASE20_RANKS, phase20_ranks,
                                     (settings,),
                                     **rank_devices(PHASE20_RANKS))
    counts = {fn.__name__: fn.launches for fn in fa.KERNELS}
    t_ranks = time.perf_counter()
    ranks = ranked['ranks']
    report = {}
    # (a) on two ranks against the one-rank control.
    cfg = moe_config(moe, 'bf16', MOE_LAYERS)
    report_ranks('moe', ranks, [2 * cfg.n_layers, cfg.n_layers,
                                cfg.n_layers])
    report_ranks('moe no model sum', ranks)
    tol = SHARD_TOL['bf16']
    axes = ', '.join(f'{a} {n}' for a, n in MOE_MESH.items() if n > 1)
    sound = check_against(f'(a) {MOE_MODEL} over ({axes})',
                          ranks[0]['moe'], moe_run, tol, MOE_STEPS, card)
    broken = check_against("(a) the same with the 'model' part of the "
                           "experts' sum left out (step 1, no update)",
                           ranks[0]['moe no model sum'], moe_run, tol, 1,
                           card)
    local = [r['moe']['local_we1'][1:] for r in ranks[:MOE_RANKS]]
    want = [[cfg.n_experts // MOE_MESH.get('expert', 1),
             cfg.dim // MOE_MESH.get('fsdp', 1),
             cfg.ffn_dim // MOE_MESH.get('model', 1)]] * MOE_RANKS
    print(f'[phase 20] (a) we1 a rank (experts, d, f) {local}', flush=True)
    if not within(sound, tol):
        fail(f'phase 20 (a): the ({axes}) mesh against one rank: {sound}')
    if within(broken, tol):
        fail(f"phase 20 (a): the 'model' sum left out still passes the "
             f'bounds ({broken}): they cannot tell it')
    if local != want:
        fail(f'phase 20 (a): we1 a rank {local}, expected {want}')
    report['moe'] = dict(sound=sound, no_model_sum=broken,
                         losses=moe_run['losses'])
    # (b) GPipe against the one-rank controls.
    for stages, dtype_name, layers in ((PP_STAGES[0], 'bf16', None),
                                       (PP_STAGES[0], 'fp32',
                                        PP_FP32_LAYERS),
                                       (PP_STAGES[1], 'bf16', None)):
        label = f'gpipe stage {stages} {dtype_name}'
        n_layers = layers or llama.CONFIGS[TRAIN_MODEL].n_layers
        per = n_layers // stages * PP_MICRO
        # Bubbles skipped: each stage runs its L/S layers on each of the
        # M microbatches once forward, once in the recompute.
        report_ranks(label, ranks, [2 * per, per, per])
        if any(r[label]['layers'] != n_layers // stages
               for r in ranks[:stages]):
            fail(f'phase 20 {label}: a stage holds the wrong layers')
        worst = check_against(f'(b) {label}', ranks[0][label],
                              pp_controls[dtype_name],
                              SHARD_TOL[dtype_name], PP_STEPS, card)
        if not within(worst, SHARD_TOL[dtype_name]):
            fail(f'phase 20 (b) {label}: {worst}')
        report[label] = worst
    # (c) ring.
    for dtype_name in ('bf16', 'fp32'):
        report_ranks(f'ring {dtype_name}', ranks)
    report['ring'] = ring_check(torch, fa, ranked['ring'], card)
    del ranked
    empty_cache(torch)
    if DEVICE == 'cuda':
        report['moe kernels'] = kernel_twin_check(torch, fa, MOE_FLASH_CASE,
                                                  'phase 20', 20)
    report['moe fp32'] = moe_fp32_check(torch, moe, card)
    print(f'[time] phase 20: controls {t_controls - t_start:.1f}s, (a) one '
          f'rank {t_moe - t_controls:.1f}s, four ranks {t_ranks - t_moe:.1f}'
          f's, checks {time.perf_counter() - t_ranks:.1f}s', flush=True)
    return counts, report


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

    last = [t_start]

    def phase_done(label):
        now = time.perf_counter()
        print(f'[time] {label}: {now - last[0]:.1f}s, done at '
              f'{now - t_start:.1f}s', flush=True)
        last[0] = now

    phase_done('phase 1 (the build and SASS checks)')
    rows = kernel_phase(torch, da, quant)
    phase_done('phase 2')
    params, counts, paged_batches, paged_results, dense_results = \
        main_path_phase(torch, ms_lib, da, card)
    phase_done('phase 3')
    worst = e2e_phase(torch, decode, llama, params)
    print(f'[e2e] worst max|dlogit| / max|logit|: {worst}', flush=True)
    phase_done('phase 4')
    phase5 = profile_phase(torch, decode, llama, params, card)
    phase_done('phase 5')

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
    with served_depth(ms_lib, params, PREFIX_LAYERS) as cut:
        prefix_report = prefix_fetch_phase(torch, ms_lib, da, cut, card)
    phase13_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 13] launches {phase13_counts}; {prefix_report}',
          flush=True)
    phase_done('phase 13')

    # Phase 15 (the disaggregated handoff) while the weights are up.
    da.reset_launch_counts()
    with served_depth(ms_lib, params, HANDOFF_LAYERS) as cut:
        handoff_report = handoff_phase(torch, ms_lib, da, cut, card)
    phase15_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 15] launches {phase15_counts}; {handoff_report}',
          flush=True)
    phase_done('phase 15')

    # Phase 16 (the durable block store) while the weights are up.
    da.reset_launch_counts()
    with served_depth(ms_lib, params, STORE_LAYERS) as cut:
        store_report = store_phase(torch, ms_lib, da, cut, card)
    phase16_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 16] launches {phase16_counts}; {store_report}',
          flush=True)
    phase_done('phase 16')

    # Phase 17 (the compiled rounds, graph against eager) while the
    # weights are up.
    da.reset_launch_counts()
    graphs_report = graph_phase(torch, ms_lib, quant, da, decode, params,
                                dense_results, paged_batches, card)
    phase17_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 17] launches {phase17_counts}; {graphs_report}',
          flush=True)
    if not all(phase17_counts.values()):
        fail(f'a decode kernel was not launched in phase 17: '
             f'{phase17_counts}')
    phase_done('phase 17')

    # Phase 18 (the TP replica) while the weights are up.
    da.reset_launch_counts()
    with served_depth(ms_lib, params, TP_LAYERS) as cut:
        tp_report = tp_phase(torch, ms_lib, da, quant, decode, llama, cut,
                             paged_batches, card)
    phase18_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 18] launches {phase18_counts}; {tp_report}', flush=True)
    for kname in ('paged_decode_attention_kernel',
                  'paged_verify_attention_kernel'):
        if not phase18_counts[kname]:
            fail(f'{kname} was not launched in phase 18: {phase18_counts}')
    phase_done('phase 18')

    # Phase 21 (the static generate and the dense insert, compiled
    # against eager) while the weights are up.
    da.reset_launch_counts()
    compiled_report = compiled_dispatch_phase(torch, ms_lib, decode, llama,
                                              da, params, card)
    phase21_counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    print(f'[phase 21] launches {phase21_counts}; {compiled_report}',
          flush=True)
    if not phase21_counts['decode_attention_kernel']:
        fail(f'decode_attention_kernel was not launched in phase 21: '
             f'{phase21_counts}')
    # The last cut's views hold every layer's storage: let them go too.
    del params, cut, spec_runs, paged_results, dense_results
    torch.cuda.empty_cache()
    phase_done('phase 21')

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
    phase19_counts, sharded = shard_phase(torch, llama, train, fa, card)
    print(f'[phase 19] launches in rank 0\'s process {phase19_counts}; '
          f'{sharded}', flush=True)
    if not all(phase19_counts.values()):
        fail(f'a flash kernel was not launched in phase 19: '
             f'{phase19_counts}')
    phase_done('phase 19')
    phase20_counts, phase20 = moe_pp_ring_phase(torch, llama, train, fa,
                                                card)
    print(f'[phase 20] launches in rank 0\'s process {phase20_counts}; '
          f'{phase20}', flush=True)
    if not all(phase20_counts.values()):
        fail(f'a flash kernel was not launched in phase 20: '
             f'{phase20_counts}')
    phase_done('phase 20')

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
            'phase15_launches': phase15_counts[kname],
            'phase16_launches': phase16_counts[kname],
            'phase17_launches': phase17_counts[kname],
            'phase18_launches': phase18_counts[kname],
            'phase21_launches': phase21_counts[kname]})
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
            phase15_counts['paged_verify_attention_kernel'],
        'phase16_launches':
            phase16_counts['paged_verify_attention_kernel'],
        'phase17_launches':
            phase17_counts['paged_verify_attention_kernel'],
        'phase18_launches':
            phase18_counts['paged_verify_attention_kernel'],
        'phase21_launches':
            phase21_counts['paged_verify_attention_kernel']})
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
            'phase14_launches': phase14_counts[kname],
            'phase19_launches': phase19_counts[kname],
            'phase20_launches': phase20_counts[kname]})
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
