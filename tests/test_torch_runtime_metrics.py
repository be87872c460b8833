"""The port's runtime telemetry (skypilot_tpu_torch/observability/
runtime_metrics.py, utils/accelerator_registry.py, and its call sites in
models/train.py and models/decode.py) against the JAX reference's.

* ``TrainTelemetry``, ``record_decode_phase`` and ``record_kv_cache`` fed
  the same inputs give a byte-identical ``generate_latest()`` in the two
  packages' registries (names, help strings, buckets, values), with
  ``SKYTPU_PEAK_FLOPS`` set and with the peak unknown (the CPU);
* ``StepProfiler`` arms after its skip steps, captures
  ``SKYTPU_PROFILE_STEPS`` steps into a ``torch.profiler`` trace under
  ``$SKYTPU_PROFILE_DIR/<tag>``, counts the capture, degrades a bad step
  count to 3 and does nothing without the env;
* ``train_loop`` publishes the four train series and writes a capture;
  ``generate`` counts its requests and sets the KV-cache gauges as the
  reference's ``generate`` does.
"""
import dataclasses
import glob
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.observability import metrics as rmetrics
from skypilot_tpu.observability import runtime_metrics as rruntime
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain
from skypilot_tpu_torch.observability import metrics as tmetrics
from skypilot_tpu_torch.observability import runtime_metrics as truntime
from skypilot_tpu_torch.utils import accelerator_registry

torch.set_num_threads(2)

STEP_SECONDS = [0.5, 0.74, 0.0, 1.3, 0.0004, 12.0, 75.0]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in (truntime.PROFILE_DIR_ENV, truntime.PROFILE_STEPS_ENV,
                 truntime.PEAK_FLOPS_ENV):
        monkeypatch.delenv(name, raising=False)
    prev = [m.set_registry(m.MetricsRegistry()) for m in (rmetrics,
                                                          tmetrics)]
    yield
    rmetrics.set_registry(prev[0])
    tmetrics.set_registry(prev[1])


def _expositions():
    return rmetrics.generate_latest(), tmetrics.generate_latest()


@pytest.mark.parametrize('peak', ['1e12', None])
def test_train_telemetry_exposition_matches_reference(peak, monkeypatch):
    if peak:
        monkeypatch.setenv(truntime.PEAK_FLOPS_ENV, peak)
    seq_len = 32
    ref = rruntime.TrainTelemetry(jllama.CONFIGS['debug'], seq_len)
    port = truntime.TrainTelemetry(tllama.CONFIGS['debug'], seq_len,
                                   device='cpu')
    for secs in STEP_SECONDS:
        ref.record_step(tokens=2 * seq_len, step_seconds=secs)
        port.record_step(tokens=2 * seq_len, step_seconds=secs)
    want, got = _expositions()
    assert got == want
    text = got.decode()
    assert 'skytpu_train_steps_total 7' in text
    mfu = tmetrics.get_registry().get('skytpu_train_mfu').value()
    if peak:
        tps = 2 * seq_len / STEP_SECONDS[-1]
        assert mfu == ttrain.tokens_per_second_to_mfu(
            tps, tllama.CONFIGS['debug'], seq_len, 1e12) > 0
    else:
        assert mfu == 0.0


def test_train_telemetry_first_step_arms_silently(monkeypatch):
    """Without step_seconds: the first record only arms the timer (it
    counts the step, observes nothing); later ones observe the deltas."""
    monkeypatch.setenv(truntime.PEAK_FLOPS_ENV, '1e12')
    clock = iter([10.0, 10.0, 10.5, 10.5, 11.25, 11.25, 11.5, 11.5])
    monkeypatch.setattr(time, 'perf_counter', lambda: next(clock))
    ref = rruntime.TrainTelemetry(jllama.CONFIGS['debug'], 32)
    port = truntime.TrainTelemetry(tllama.CONFIGS['debug'], 32)
    for _ in range(4):
        ref.record_step(tokens=64)
        port.record_step(tokens=64)
    want, got = _expositions()
    assert got == want
    hist = tmetrics.get_registry().get('skytpu_train_step_seconds')
    assert hist.count() == 3 and hist.sum() == 1.5


def test_decode_phase_and_kv_cache_exposition_matches_reference():
    calls = [
        ('decode', dict(prefill_seconds=0.12, decode_seconds=0.64,
                        batch=8, new_tokens=32)),
        ('decode', dict(prefill_seconds=2.7, decode_seconds=0.0,
                        batch=1, new_tokens=0, kv_cache_dtype='int8')),
        ('decode', dict(prefill_seconds=0.004, decode_seconds=1.5,
                        batch=4, new_tokens=16, kv_cache_dtype='int8',
                        completed_tokens=41)),
        ('kv', (8, 2048, 1032, 'bf16')),
        ('kv', (2, 128, 40, 'int8')),
        ('kv', (4, 64, 64, 'bf16')),
    ]
    for kind, args in calls:
        for mod in (rruntime, truntime):
            if kind == 'decode':
                mod.record_decode_phase(**args)
            else:
                mod.record_kv_cache(*args)
    want, got = _expositions()
    assert got == want
    dtypes = tmetrics.get_registry().get('skytpu_decode_kv_cache_dtype_info')
    assert (dtypes.value(('bf16',)), dtypes.value(('int8',))) == (1, 0)


def _run_steps(profiler, n):
    states = []
    for _ in range(n):
        profiler.step()
        torch.ones(8, 8) @ torch.ones(8, 8)
        states.append(profiler.active)
    return states


def _captures():
    counter = tmetrics.get_registry().get('skytpu_profile_captures_total')
    return None if counter is None else counter.value()


@pytest.mark.parametrize('steps_env,window', [('2', 2), ('bogus', 3)])
def test_step_profiler_window(steps_env, window, tmp_path, monkeypatch):
    monkeypatch.setenv(truntime.PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(truntime.PROFILE_STEPS_ENV, steps_env)
    profiler = truntime.StepProfiler(tag='train', skip_steps=1)
    states = _run_steps(profiler, 6)
    # Step 1 is skipped; the next `window` steps are captured; the step
    # after them stops the capture.
    assert states == [False] + [True] * window + [False] * (5 - window)
    profiler.stop()                              # idempotent
    assert _captures() == 1
    traces = glob.glob(str(tmp_path / 'train' / '*.pt.trace.json'))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'aten::mm' in names


def test_step_profiler_stop_ends_an_open_capture(tmp_path, monkeypatch):
    monkeypatch.setenv(truntime.PROFILE_DIR_ENV, str(tmp_path))
    profiler = truntime.StepProfiler(tag='eval', skip_steps=0)
    assert _run_steps(profiler, 2) == [True, True]
    profiler.stop()
    assert not profiler.active
    assert len(glob.glob(str(tmp_path / 'eval' / '*.pt.trace.json'))) == 1


def test_step_profiler_is_a_noop_without_the_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    profiler = truntime.StepProfiler()
    assert _run_steps(profiler, 5) == [False] * 5
    profiler.stop()
    assert _captures() is None
    assert not glob.glob(str(tmp_path / '**' / '*.json'), recursive=True)


def test_peak_flops(monkeypatch):
    reg = accelerator_registry
    assert reg.peak_bf16_flops('NVIDIA H100 80GB HBM3') == 989e12
    assert reg.peak_bf16_flops('NVIDIA H100 NVL') == 835e12
    assert reg.peak_bf16_flops('NVIDIA H100 PCIe') == 756e12
    assert reg.peak_bf16_flops('NVIDIA GeForce GTX 1080') == 0.0
    assert reg.peak_bf16_flops('cpu') == 0.0
    assert reg.peak_bf16_flops(torch.device('cpu')) == 0.0
    assert truntime.peak_flops('cpu') == 0.0
    monkeypatch.setenv(truntime.PEAK_FLOPS_ENV, '2.5e14')
    assert truntime.peak_flops('cpu') == 2.5e14
    monkeypatch.setenv(truntime.PEAK_FLOPS_ENV, 'fast')
    assert truntime.peak_flops('cpu') == 0.0


def test_train_loop_publishes_and_profiles(tmp_path, monkeypatch):
    monkeypatch.setenv(truntime.PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(truntime.PROFILE_STEPS_ENV, '2')
    monkeypatch.setenv(truntime.PEAK_FLOPS_ENV, '1e12')
    cfg = tllama.CONFIGS['debug']
    seen = []
    ttrain.train_loop(cfg, ttrain.TrainConfig(warmup_steps=2), 4, 2, 32,
                      log_every=0, device='cpu',
                      on_step=lambda i, m: seen.append(i))
    assert seen == [1, 2, 3, 4]
    reg = tmetrics.get_registry()
    assert reg.get('skytpu_train_steps_total').value() == 4
    assert reg.get('skytpu_train_step_seconds').count() == 3
    tps = reg.get('skytpu_train_tokens_per_second').value()
    assert tps > 0
    assert reg.get('skytpu_train_mfu').value() == (
        ttrain.tokens_per_second_to_mfu(tps, cfg, 32, 1e12))
    assert _captures() == 1
    assert len(glob.glob(str(tmp_path / 'train' / '*.pt.trace.json'))) == 1


def test_generate_counts_requests_and_sets_kv_gauges():
    """Both packages' generate on the same weights and prompts publish
    the same decode series (and the same tokens)."""
    jcfg, tcfg = jllama.CONFIGS['debug'], tllama.CONFIGS['debug']
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (2, 8), dtype=np.int32)
    lens = np.array([8, 5], np.int32)
    outs = []
    for kv in ('bf16', 'int8'):
        jd = jdecode.DecodeConfig(max_len=32, kv_cache_dtype=kv)
        td = dataclasses.replace(tdecode.DecodeConfig(max_len=32),
                                 kv_cache_dtype=kv)
        want = jdecode.generate(jparams, jnp.asarray(prompt),
                                jnp.asarray(lens), jcfg, jd, 4)
        got = tdecode.generate(tparams, torch.from_numpy(prompt),
                               torch.from_numpy(lens), tcfg, td, 4)
        outs.append((np.asarray(want), got.numpy()))
    for want, got in outs:
        np.testing.assert_array_equal(got, want)
    want, got = _expositions()
    assert got == want
    reg = tmetrics.get_registry()
    assert reg.get('skytpu_decode_requests_total').value() == 2
    tokens = reg.get('skytpu_decode_kv_cache_tokens')
    assert tokens.value(('capacity',)) == 64 and tokens.value(('used',)) == 24
