"""The yardstick's counts against hand arithmetic and against the
kernel table's bounds (PERF.md, the port's kernels section): decode
attention at q [8, 1, 32, 128] over an [8, 2048, 8, 128] cache with
live lengths [0, 1, 127, 128, 129, 2048, 1000, 513]: 0.0049 ms; the
causal flash forward at B 12, S 2048, H 16, D 128: 0.2086 ms; and the
reduction of a profiler trace to busy time, top operations and gaps."""
import json

import pytest

from portbench import harness, peaks

LENS = [0, 1, 127, 128, 129, 2048, 1000, 513]


def test_decode_attention_bound_matches_the_kernel_table():
    nbytes = peaks.decode_attention_bytes(LENS, 32, 8, 128)
    # sum(LENS) = 3946 rows of K and V, 8 heads of 128 bf16 each, plus q
    # and the output (8 x 32 x 128 bf16 each) and 8 int32 lengths.
    assert nbytes == 3946 * 8 * 128 * 2 * 2 + 2 * 8 * 32 * 128 * 2 + 32
    seconds, what = peaks.decode_attention_bound_s(LENS, 32, 8, 128)
    assert what == 'bytes'
    assert round(seconds * 1e3, 4) == 0.0049


def test_flash_forward_bound_matches_the_kernel_table():
    flops = peaks.flash_forward_flops(12, 2048, 16, 128)
    assert flops == 4 * 12 * 16 * 128 * (2048 * 2049 // 2)
    assert round(peaks.flash_forward_bound_s(12, 2048, 16, 128) * 1e3,
                 4) == 0.2086


def test_flash_backward_is_five_products():
    assert peaks.flash_backward_flops(2, 64, 4, 32) == pytest.approx(
        2.5 * peaks.flash_forward_flops(2, 64, 4, 32))


def test_mixtral_active_params_and_train_flops():
    # Attention 4096 x (32 + 16) x 128 + 4096 x 4096, router 4096 x 8,
    # two SwiGLU experts of 3 x 4096 x 14336.
    per_layer = peaks.moe_block_active_params(4096, 32, 8, 128, 14336, 8, 2)
    assert per_layer == 41_943_040 + 32_768 + 352_321_536
    active = 2 * per_layer + 4096 * 32000
    per_token = peaks.train_flops_per_token(active, 2, 32, 128, 2048)
    attn = 2 * (4 + 10) * 32 * 128 * (2048 * 2049 // 2) / 2048
    assert per_token == pytest.approx(6 * active + attn)
    assert 5.5e9 < per_token < 5.8e9


def test_mistral_block_params_and_serve_flops():
    per_layer = peaks.dense_block_params(4096, 32, 8, 128, 14336)
    # Mistral-7B-v0.3: 32 such blocks, 65 norms of 4096, an embedding and
    # an output head of 32768 x 4096.
    total = 32 * per_layer + 2 * 32768 * 4096 + (2 * 32 + 1) * 4096
    assert total == 7_248_023_552
    flops = peaks.serve_flops(1000, 2, 4, 8, [3], [5, 6])
    assert flops == 2 * 1000 * 5 + 4 * 2 * 4 * 8 * (6 + 11)


def test_trace_is_read_over_its_window_mark(tmp_path):
    """Device operations are clipped to the marked window; busy time is
    their union; gaps run from the mark's start to its end."""
    events = [
        {'ph': 'X', 'name': harness.WINDOW_MARK, 'cat': 'user_annotation',
         'ts': 100, 'dur': 1000},
        {'ph': 'X', 'name': 'k1', 'cat': 'kernel', 'ts': 50, 'dur': 100},
        {'ph': 'X', 'name': 'k2', 'cat': 'kernel', 'ts': 300, 'dur': 200},
        {'ph': 'X', 'name': 'k1', 'cat': 'kernel', 'ts': 400, 'dur': 300},
        {'ph': 'X', 'name': 'k3', 'cat': 'kernel', 'ts': 1050, 'dur': 100},
        {'ph': 'X', 'name': 'cudaGraphLaunch', 'cat': 'cuda_runtime',
         'ts': 150, 'dur': 140}]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    trace = harness.reduce_trace(path)
    assert trace.window_s == pytest.approx(1e-3)
    # [100, 150] + [300, 700] + [1050, 1100]
    assert trace.busy_s == pytest.approx(500e-6)
    assert trace.breakdown['device_ops'][0] == ['k1', pytest.approx(350e-6)]
    assert trace.breakdown['idle_gaps'] == [
        ['host: no host operation traced', pytest.approx(350e-6)],
        ['host: cudaGraphLaunch', pytest.approx(150e-6)]]


def test_engine_metrics_leave_out_the_profilers_hold():
    """A traced serving run's engine readers skip the requests alive and
    the steps run while the profiler held the engine, and the MFU the
    held seconds; an untraced run's count everything."""
    from portbench.kinds import serve
    from portbench.weights import Dims
    d = Dims(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=64, rope_theta=1e4, norm_eps=1e-5)

    def rec(i, due, times):
        return {'id': str(i), 'due': due, 'counted': True, 'prompt_len': 8,
                'max_new_tokens': len(times), 'times': times,
                'tokens': [1] * len(times), 'error': None, 'sent': due}

    records = [rec(0, 1.0, [1.1, 1.2, 1.3]), rec(1, 5.0, [5.5, 8.5]),
               rec(2, 9.0, [9.1, 9.2])]
    requests = [{'trace_id': str(i), 'prompt_len': 8,
                 'prefix_hit_tokens': 0,
                 'phases': {'queue_wait': 0.01 * (i + 1)}}
                for i in range(3)]
    # Window [0, 10] monotonic = [1000, 1010] unix; steps end at unix_ts.
    steps = [{'unix_ts': 1000.0 + t, 'step_seconds': 0.1}
             for t in (1.0, 6.0, 9.5)]
    ctx = serve.ServeContext(dims=d, traffic={}, records=records,
                             window=(0.0, 10.0), window_unix=(1000.0, 1010.0),
                             setup_s=1.0, requests=requests, steps=steps)
    assert [r['id'] for r in ctx.unheld()] == ['0', '1', '2']
    assert len(ctx.unheld_steps()) == 3
    assert ctx.unheld_seconds() == 10.0
    ctx.held = (6.0, 8.0)
    assert [r['id'] for r in ctx.unheld()] == ['0', '2']
    assert [r['trace_id'] for r in ctx.unheld_requests()] == ['0', '2']
    assert [s['unix_ts'] for s in ctx.unheld_steps()] == [1001.0, 1009.5]
    assert ctx.unheld_seconds() == 8.0
    assert harness.metric_reader('engine.queue_wait_ms.p95')(ctx) == 30.0
    assert harness.metric_reader('step.round_ms')(ctx) == pytest.approx(100)
    traced = harness.metric_reader('mfu.serve')(ctx)
    ctx.held = None
    # The held seconds held no token, so only the window's length moves.
    assert traced == pytest.approx(
        harness.metric_reader('mfu.serve')(ctx) * 10.0 / 8.0)


def test_knee_counts_queue_and_live_pool_by_hand():
    from portbench import knee
    recs = [{'due': 0.0, 'times': [0.5, 1.0, 2.5], 'prompt_len': 130},
            {'due': 1.0, 'times': [], 'prompt_len': 10}]
    assert knee.queued(recs, 0.2) == 1 and knee.queued(recs, 2.0) == 1
    # Streaming at 1 s and 2 s: 130 + 2 tokens, two blocks of 128, of 10.
    assert knee.kv_live_share(recs, 0.0, 3.0, 128, 10) == pytest.approx(0.1)
    rising = [{'due': float(t), 'times': [], 'prompt_len': 1}
              for t in range(10)]
    assert knee.slope(knee.queued, rising, 0.0, 9.0) == pytest.approx(1.0)
