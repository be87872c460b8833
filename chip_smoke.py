#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, printing no result, when CUDA is unavailable or the
port's package is not beside it. Phases (any failure exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``); build every
   CUDA kernel from ``skypilot_tpu_torch/csrc`` (one nvcc per source,
   started together) and print the build seconds and ptxas report.
2. Kernels against their plain PyTorch versions at the serving path's
   shapes (B=8, H=32, Hkv=8, hd=128, max_len 2048, block_k 128, ragged
   lengths 0/1/127/128/129/2048/...): dense bf16 and int8, paged bf16
   and int8 through shuffled tables with two rows sharing blocks. Prints
   each max abs error against its tolerance, the kernel's time, the
   plain version's time, ``library_ms`` (``scaled_dot_product_attention``
   over expanded K/V, a yardstick the port never calls) and the bytes
   bound.
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
   torch.profiler's device time by kernel over the kernel path.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import threading
import time
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

MODEL = 'llama3-8b'
N_NEW = 32
# Main-path and end-to-end phases run here (a rehearsal may point them
# at the CPU and a small model; the kernel phase always needs the card).
DEVICE = 'cuda'


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(torch) -> None:
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.synchronize()


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
            ms = cuda_time_ms(lambda: kernel_fn(*args))
            plain_ms = cuda_time_ms(lambda: plain_fn(*args), iters=5)
            sq, sk, sv, mask = sdpa_inputs(kk, vv, kss, vss,
                                           tables if is_paged else None)
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask))
            bound_ms, bound_by = bound(kind, is_paged)
            print(f'[kernels] {name} {kind}: ms={ms:.4f} '
                  f'plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} '
                  f'bound_ms={bound_ms:.4f} ({bound_by})', flush=True)
            row[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
        rows[name] = row
    return rows


# --------------------------------------------------------------- phase 3


def post(port: int, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read().decode()
        if not body.get('stream', True):
            return json.loads(raw)
    events = [json.loads(line[len('data: '):])
              for line in raw.splitlines() if line.startswith('data: ')]
    if not events or not events[-1].get('done'):
        fail(f'stream ended without a done event: {events[-1:]}')
    if 'error' in events[-1]:
        fail(f'stream error: {events[-1]}')
    return {'tokens': [e['token'] for e in events],
            'generated': events[-1]['generated'],
            'finish_reason': events[-1]['finish_reason']}


def serve_phase(torch, ms_lib, params, label, engine_kwargs, requests,
                kernel_fn, card):
    """One replica: start the port's server, answer ``requests`` (lists
    of (body) batches sent concurrently), check counts. Returns stats."""
    engine = ms_lib.build_engine(MODEL, 8, MAX_LEN, step_chunk=4,
                                 device=DEVICE, params=params,
                                 **engine_kwargs)
    server = ms_lib.ModelServer(engine, 0, host='127.0.0.1')
    port = server.start()
    before = kernel_fn.launches
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
    tok_s = stats['decode_tokens'] / wall
    print(f'[serve] {label}: {len(results)} requests, decode_steps='
          f'{stats["decode_steps"]} decode_tokens={stats["decode_tokens"]} '
          f'{kernel_fn.__name__} launches={launches} wall={wall:.2f}s '
          f'decode tokens/s={tok_s:.1f} on {card}', flush=True)
    return stats


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
    da.reset_launch_counts()
    serve_phase(torch, ms_lib, params, 'dense bf16', {}, [dense_batch],
                da.decode_attention_kernel, card)
    serve_phase(torch, ms_lib, params, 'dense int8-KV', {'kv_int8': True},
                [dense_batch], da.decode_attention_kernel, card)
    paged = serve_phase(torch, ms_lib, params, 'paged bf16',
                        {'paged': True}, paged_batches,
                        da.paged_decode_attention_kernel, card)
    counts = {fn.__name__: fn.launches for fn in da.KERNELS}
    for name, n in counts.items():
        if n == 0:
            fail(f'{name} was never launched on the main path')
    if paged['prefill_tokens_saved'] <= 0:
        fail(f'paged replica reused no prefix: {paged}')
    print(f'[serve] paged prefix hit tokens={paged["prefill_tokens_saved"]}'
          f' blocks_used={paged["blocks_used"]}', flush=True)
    return params, counts


# --------------------------------------------------------------- phase 4


def e2e_phase(torch, decode, llama, params):
    """Teacher-forced decode steps, kernel vs plain, dense and paged, in
    fp32 (the kernel and the plain path differ only in summation order)
    and in bf16 (the serving dtype). Returns the worst relative diff per
    dtype."""
    import dataclasses
    cfg16 = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    b, s, steps, max_len = 4, 300, 4, 512
    prompt = torch.randint(0, cfg16.vocab_size, (b, s), generator=gen,
                           device=dev)
    lens = torch.tensor([300, 129, 17, 256], device=dev)
    forced = torch.randint(0, cfg16.vocab_size, (steps, b), generator=gen,
                           device=dev)
    nbk = max_len // BLOCK_K
    # Each row's blocks at reversed pool positions.
    tables = (torch.arange(b * nbk, device=dev) + 1).flip(0).reshape(
        b, nbk).to(torch.int32)
    padded = torch.nn.functional.pad(prompt,
                                     (0, -(-s // BLOCK_K) * BLOCK_K - s))

    def run(p, cfg, paged, impl):
        dcfg = decode.DecodeConfig(max_len=max_len, decode_attention=impl)
        if paged:
            cache = decode.init_block_pool(cfg, b * nbk + 1, BLOCK_K,
                                           device=dev)
            for i in range(b):
                decode.paged_prefill(p, padded[i:i + 1], int(lens[i]),
                                     tables[i, :padded.shape[1] // BLOCK_K],
                                     cfg, cache)
        else:
            cache = decode.init_kv_cache(cfg, b, max_len, device=dev)
            decode.prefill(p, prompt, cfg, cache, lens)
        outs = []
        pos = lens.clone()
        for t in range(steps):
            if paged:
                outs.append(decode.paged_decode_step(p, forced[t], pos,
                                                     tables, cfg, dcfg,
                                                     cache))
            else:
                outs.append(decode.decode_step(p, forced[t], pos, cfg, dcfg,
                                               cache))
            pos = pos + 1
        return torch.stack(outs)

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
            kl = run(p, cfg, paged, 'kernel')
            pl = run(p, cfg, paged, 'plain')
            if not (torch.isfinite(kl).all() and kl.shape ==
                    (steps, b, cfg.vocab_size)):
                fail('end-to-end kernel logits not finite / wrong shape')
            scale = pl.abs().max().item()
            diff = (kl - pl).abs().max().item()
            tol = rel_tol * scale
            top2 = pl.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > tol
            agree = kl.argmax(-1) == pl.argmax(-1)
            label = f'{dtype_name} {"paged" if paged else "dense"}'
            print(f'[e2e] {label}: max|dlogit|={diff:.4e} (tol {tol:.4e} = '
                  f'{rel_tol} x max|logit| {scale:.3f}); greedy equal on '
                  f'{int(agree[clear].sum())}/{int(clear.sum())} clear-gap '
                  f'positions, {int(agree.sum())}/{agree.numel()} overall',
                  flush=True)
            if diff > tol:
                fail(f'end-to-end {label} logits differ by {diff} > {tol}')
            if not agree[clear].all():
                fail(f'end-to-end {label} greedy tokens differ at a clear '
                     'gap')
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), diff / scale)
        del p
        sync(torch)
        torch.cuda.empty_cache() if dev.type == 'cuda' else None
    return worst


# --------------------------------------------------------------- phase 5


PROFILE_LENS = [16, 200, 1000, 77, 512, 333, 700, 900]


def profile_phase(torch, decode, llama, params, card):
    """Where one decode step's time goes: the 8-slot dense and paged bf16
    steps at ragged live lengths (PROFILE_LENS), host clock around
    synchronised steps for 'kernel' and 'plain', then torch.profiler
    over the kernel path for device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    cfg = llama.CONFIGS[MODEL]
    dev = torch.device(DEVICE)
    b = len(PROFILE_LENS)
    pos0 = torch.tensor(PROFILE_LENS, device=dev)
    token = torch.zeros(b, dtype=torch.long, device=dev)
    nbk = MAX_LEN // BLOCK_K
    tables = (torch.arange(b * nbk, device=dev) + 1).reshape(b, nbk).to(
        torch.int32)
    for paged in (False, True):
        if paged:
            cache = decode.init_block_pool(cfg, b * nbk + 1, BLOCK_K,
                                           device=dev)
        else:
            cache = decode.init_kv_cache(cfg, b, MAX_LEN, device=dev)
        label = 'paged' if paged else 'dense'

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
        print(f'[profile] {label} bf16 decode step, 8 slots, live lengths '
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
        # Device-side events only: a CPU op's device time repeats its
        # kernels' time.
        rows = [(evt.self_device_time_total / 1e3, evt.key, evt.count)
                for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA and
                evt.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        if busy_ms == 0:
            print(f'[profile] {label}: the profiler recorded no device '
                  'time', flush=True)
            continue
        attn_ms = sum(r[0] for r in rows if 'decode_attention' in r[1])
        gemm_ms = sum(r[0] for r in rows
                      if 'nvjet' in r[1] or 'gemm' in r[1].lower())
        launches = sum(r[2] for r in rows)
        print(f'[profile] {label}: {n_prof} steps under torch.profiler: '
              f'wall {wall_ms / n_prof:.3f} ms/step, device busy '
              f'{busy_ms / n_prof:.3f} ms/step ({busy_ms / wall_ms:.3f} of '
              f'wall), {launches / n_prof:.0f} kernels/step; decode '
              f'attention {attn_ms / n_prof:.3f} ms/step '
              f'({attn_ms / busy_ms:.3f} of device time), GEMMs '
              f'{gemm_ms / n_prof:.3f} ms/step ({gemm_ms / busy_ms:.3f})',
              flush=True)
        for ms, key, count in rows[:6]:
            print(f'[profile] {label}:   {ms / n_prof:8.3f} ms/step  '
                  f'x{count // n_prof:<4d} {key[:80]}', flush=True)
        del cache


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; nothing to run.',
              file=sys.stderr)
        return 2
    try:
        from skypilot_tpu_torch.models import decode, llama
        from skypilot_tpu_torch.ops import cuda_build, quant
        from skypilot_tpu_torch.ops import decode_attention as da
        from skypilot_tpu_torch.serve import model_server as ms_lib
    except ImportError as e:
        print(f'chip_smoke: the skypilot_tpu_torch package is not beside '
              f'this script ({e}); run it from the root of a checkout.',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f'[device] {name} | nvidia-smi: {card} | torch {torch.__version__}'
          f' cuda {torch.version.cuda}', flush=True)
    built = cuda_build.build()
    for lib, secs in built.items():
        print(f'[build] {lib}: {secs:.1f}s', flush=True)
        log = cuda_build.library_path(lib).with_suffix('.log')
        print(log.read_text(errors='replace').strip(), flush=True)

    rows = kernel_phase(torch, da, quant)
    params, counts = main_path_phase(torch, ms_lib, da, card)
    worst = e2e_phase(torch, decode, llama, params)
    print(f'[e2e] worst max|dlogit| / max|logit|: {worst}', flush=True)
    profile_phase(torch, decode, llama, params, card)

    sources = {'decode_attention_kernel':
               'skypilot_tpu/ops/decode_attention.py:80',
               'paged_decode_attention_kernel':
               'skypilot_tpu/ops/decode_attention.py:273'}
    kernels = []
    for kname, row in rows.items():
        main = row['bf16']
        kernels.append({
            'name': kname, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': sources[kname], 'launches': counts[kname],
            'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
            'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
            'bound_by': main['bound_by'],
            'library_ms': main['library_ms'], 'int8': row['int8']})
    print(f'[done] {time.perf_counter() - t_start:.1f}s total', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
