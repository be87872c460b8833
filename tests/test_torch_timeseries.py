"""The port's accelerator sampler
(skypilot_tpu_torch/observability/timeseries.py) against the
reference's ``sample_accelerator``
(skypilot_tpu/observability/timeseries.py), which imports JAX only when
its gate lets it sample.

On the CPU: every ``SKYTPU_SAMPLER_ACCEL`` mode gives ``{}`` on a host
with no card, on both sides, and ``auto`` leaves CUDA uninitialised. On
the card (``cuda`` marker; ``python -m pytest --noconftest -m cuda
tests/test_torch_timeseries.py``): a forced sample's used bytes within
the total, and ``auto`` in a fresh process makes no CUDA context.
"""
import os
import subprocess
import sys

import pytest
import torch

from skypilot_tpu.observability import timeseries as rtimeseries
from skypilot_tpu_torch.observability import timeseries as ttimeseries

MODES = [None, 'auto', '0', 'off', '1', 'force', 'true']


@pytest.mark.parametrize('mode', MODES)
def test_no_card_samples_nothing_in_every_mode(monkeypatch, mode):
    if torch.cuda.is_available():
        pytest.skip('a host with no card')
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
    if mode is None:
        monkeypatch.delenv(ttimeseries.ACCEL_SAMPLING_ENV, raising=False)
    else:
        monkeypatch.setenv(ttimeseries.ACCEL_SAMPLING_ENV, mode)
    assert ttimeseries.ACCEL_SAMPLING_ENV == rtimeseries.ACCEL_SAMPLING_ENV
    assert ttimeseries.sample_accelerator() == {}
    assert rtimeseries.sample_accelerator() == {}
    assert not torch.cuda.is_initialized()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_sample_reads_the_cards(cuda, monkeypatch):
    monkeypatch.setenv(ttimeseries.ACCEL_SAMPLING_ENV, '1')
    held = torch.empty(2**28, dtype=torch.uint8, device=cuda)
    got = ttimeseries.sample_accelerator()
    assert set(got) == {'accel_count', 'accel_mem_used_bytes',
                        'accel_mem_total_bytes', 'accel_mem_util'}
    assert got['accel_count'] == torch.cuda.device_count()
    assert held.numel() <= got['accel_mem_used_bytes'] <= \
        got['accel_mem_total_bytes']
    assert 0.0 < got['accel_mem_util'] <= 1.0
    # This process holds a context on card 0, so 'auto' samples it too.
    monkeypatch.setenv(ttimeseries.ACCEL_SAMPLING_ENV, 'auto')
    assert ttimeseries.sample_accelerator()['accel_mem_total_bytes'] > 0


@pytest.mark.cuda
def test_cuda_auto_makes_no_context(cuda):
    """``auto`` in a process that never touched the card samples nothing
    and leaves CUDA uninitialised."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import torch\n'
            'from skypilot_tpu_torch.observability import timeseries\n'
            'print(timeseries.sample_accelerator(), '
            'torch.cuda.is_initialized())\n')
    env = dict(os.environ, PYTHONPATH=root)
    env.pop(ttimeseries.ACCEL_SAMPLING_ENV, None)
    out = subprocess.run([sys.executable, '-c', code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ['{}', 'False']
