"""Runtime telemetry: train step/MFU, decode TTFT + per-token latency,
KV-cache gauges, and on-demand profiler capture.

This package's copy of ``skypilot_tpu/observability/runtime_metrics.py``:
the same series, names, help strings and buckets, published through
this package's registry (``observability/metrics.py``). The replica's
``skytpu_engine_*`` histograms share the bucket schemes below.

Everything here is host-side and cheap (perf_counter deltas and dict
updates under a lock); nothing forces a device sync. The step time is
dispatch-to-dispatch wall time, which is the device step time when the
loop syncs once a step, as ``models/train.py``'s step does (it reads
the grad norm on the host to decide the clip).
"""
import os
import time
from typing import Optional

import torch

from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.utils import accelerator_registry

PROFILE_DIR_ENV = 'SKYTPU_PROFILE_DIR'
PROFILE_STEPS_ENV = 'SKYTPU_PROFILE_STEPS'
PEAK_FLOPS_ENV = 'SKYTPU_PEAK_FLOPS'

# Train-step times: one CPU debug step is ~10ms, a big pod step ~10s.
TRAIN_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# Decode per-token latencies: the 100us-2.5s band.
TOKEN_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# The long-tail end (... 2.5/5/10/30/60 s) matters as much as the fast
# end: prefill-heavy requests on a saturated replica land there, and
# without those bounds p99 TTFT saturates into +Inf and is unreadable.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def peak_flops(device=None) -> float:
    """Per-card peak bf16 FLOPs: env override (``SKYTPU_PEAK_FLOPS``),
    else the card's entry in ``utils/accelerator_registry``; 0.0 when
    unknown (the CPU, an unlisted card, no card)."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device is None:
        if not torch.cuda.is_available():
            return 0.0
        device = torch.device('cuda')
    return accelerator_registry.peak_bf16_flops(device)


class TrainTelemetry:
    """Per-step training telemetry → registry.

    Publishes ``skytpu_train_step_seconds`` (histogram),
    ``skytpu_train_tokens_per_second`` and ``skytpu_train_mfu`` (gauges,
    MFU 0.0 when the hardware peak is unknown, e.g. CPU dev runs), and
    ``skytpu_train_steps_total``.
    """

    def __init__(self, model_cfg=None, seq_len: Optional[int] = None,
                 device=None):
        self._model_cfg = model_cfg
        self._seq_len = seq_len
        self._peak = peak_flops(device)
        self._last_t: Optional[float] = None

    def step_start(self) -> None:
        """Optional explicit step boundary; record_step() alone also
        works (dispatch-to-dispatch timing)."""
        self._last_t = time.perf_counter()

    def record_step(self, tokens: int,
                    step_seconds: Optional[float] = None) -> None:
        """Record one completed step of ``tokens`` tokens.

        Without an explicit ``step_seconds``, the delta since the
        previous record/step_start is used (the first call is a silent
        arm when no boundary was set).
        """
        now = time.perf_counter()
        # Every completed step counts, including the first one that
        # only ARMS the step timer below (its time holds the kernels'
        # build and the allocator's warm-up).
        metrics.counter('skytpu_train_steps_total',
                        'Training steps completed.').inc()
        if step_seconds is None:
            if self._last_t is None:
                self._last_t = now
                return
            step_seconds = now - self._last_t
        self._last_t = now
        metrics.histogram('skytpu_train_step_seconds',
                          'Wall-clock time per training step.',
                          buckets=TRAIN_STEP_BUCKETS).observe(step_seconds)
        if step_seconds <= 0:
            return
        tps = tokens / step_seconds
        metrics.gauge('skytpu_train_tokens_per_second',
                      'Training throughput (tokens/sec, most recent '
                      'step).').set(tps)
        mfu = 0.0
        if self._peak and self._model_cfg is not None and self._seq_len:
            from skypilot_tpu_torch.models import train
            mfu = train.tokens_per_second_to_mfu(tps, self._model_cfg,
                                                 self._seq_len, self._peak)
        metrics.gauge('skytpu_train_mfu',
                      'Model FLOPs utilization of the most recent step '
                      '(0.0 when the hardware peak is unknown).').set(mfu)


def record_decode_phase(prefill_seconds: float, decode_seconds: float,
                        batch: int, new_tokens: int,
                        kv_cache_dtype: str = 'bf16',
                        completed_tokens: Optional[int] = None) -> None:
    """Record one decode run: TTFT (prefill latency) and per-token decode
    latency histograms, plus the generated-token counter.
    ``completed_tokens`` overrides the ``batch * new_tokens`` token count
    when the caller knows how many tokens were actually generated (EOS
    stops rows early; the padding is not generated output)."""
    metrics.histogram('skytpu_decode_ttft_seconds',
                      'Time to first token (prefill latency).',
                      labels=('kv_cache_dtype',),
                      buckets=TTFT_BUCKETS).observe(
                          prefill_seconds, labels=(kv_cache_dtype,))
    if new_tokens > 0:
        metrics.histogram('skytpu_decode_token_seconds',
                          'Per-token decode latency.',
                          labels=('kv_cache_dtype',),
                          buckets=TOKEN_LATENCY_BUCKETS).observe(
                              decode_seconds / new_tokens,
                              labels=(kv_cache_dtype,))
    metrics.counter('skytpu_decode_tokens_total',
                    'Tokens generated by decode.').inc(
                        batch * new_tokens if completed_tokens is None
                        else completed_tokens)
    # skytpu_decode_requests_total is incremented by decode.generate
    # itself (every call), not here: this helper only adds the latency
    # view that needs a sync boundary.


def record_kv_cache(batch: int, max_len: int, used_len: int,
                    kv_cache_dtype: str) -> None:
    """KV-cache occupancy + dtype gauges for the current decode config."""
    g = metrics.gauge('skytpu_decode_kv_cache_tokens',
                      'KV cache slots (batch * positions).',
                      labels=('kind',))
    g.set(batch * max_len, labels=('capacity',))
    g.set(batch * used_len, labels=('used',))
    dtype_g = metrics.gauge('skytpu_decode_kv_cache_dtype_info',
                            'KV cache storage dtype (1 for the active '
                            'dtype).', labels=('dtype',))
    # One process can switch cache dtypes between runs: zero the
    # inactive series so exactly one dtype reports 1.
    for dtype in {'bf16', 'int8', kv_cache_dtype}:
        dtype_g.set(1 if dtype == kv_cache_dtype else 0, labels=(dtype,))


class StepProfiler:
    """On-demand ``torch.profiler`` capture for the train loop.

    Armed by ``SKYTPU_PROFILE_DIR``: after ``skip_steps`` warm-up steps,
    the next ``SKYTPU_PROFILE_STEPS`` (default 3; a bad value degrades to
    3) steps are captured, host ops and, with a card, its kernels, and
    written as a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``, which
    Perfetto and TensorBoard's profile plugin open) under
    ``$SKYTPU_PROFILE_DIR/<tag>``. A no-op when the env is unset, so the
    hook stays wired into ``train_loop``.
    """

    def __init__(self, tag: str = 'train', skip_steps: int = 1):
        self._dir = os.environ.get(PROFILE_DIR_ENV)
        try:
            self._steps = int(os.environ.get(PROFILE_STEPS_ENV, '3'))
        except ValueError:
            self._steps = 3  # degrade, never die: bad env ≠ dead trainer
        self._skip = skip_steps  # let build/warm-up steps pass
        self._tag = tag
        self._seen = 0
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self) -> None:
        """Call once per loop iteration (before the step's work)."""
        if not self._dir:
            return
        self._seen += 1
        if self._prof is None and self._seen == self._skip + 1:
            from torch import profiler
            path = os.path.join(self._dir, self._tag)
            os.makedirs(path, exist_ok=True)
            activities = [profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(profiler.ProfilerActivity.CUDA)
            self._prof = profiler.profile(
                activities=activities,
                on_trace_ready=profiler.tensorboard_trace_handler(path))
            self._prof.start()
            metrics.counter('skytpu_profile_captures_total',
                            'torch.profiler trace captures started.').inc()
        elif self._prof is not None and self._seen > self._skip + self._steps:
            self.stop()

    def stop(self) -> None:
        """End an open capture and write its trace (after the device's
        queued work, which the trace must hold, has finished)."""
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof, self._prof = self._prof, None
            prof.stop()
