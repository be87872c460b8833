"""Accelerator memory for the host sampler.

The port's counterpart of ``sample_accelerator`` in
``skypilot_tpu/observability/timeseries.py``: the same
``SKYTPU_SAMPLER_ACCEL`` modes and the same four keys, read from
``torch.cuda`` instead of JAX's device memory stats. The rest of that
module (the skylet's host sampler and its series) runs no accelerator
code and has no counterpart here.
"""
import os
from typing import Dict

import torch

ACCEL_SAMPLING_ENV = 'SKYTPU_SAMPLER_ACCEL'


def _has_context(index: int) -> bool:
    """Whether this process already holds a CUDA context on card
    ``index`` (asking creates none)."""
    has = getattr(torch._C, '_cuda_hasPrimaryContext', None)  # pylint: disable=protected-access
    return bool(has is not None and has(index))


def sample_accelerator() -> Dict[str, float]:
    """The cards' memory, or ``{}`` on a host without one.

    ``SKYTPU_SAMPLER_ACCEL``: ``0`` (also ``off``, ``false``,
    ``disabled``) samples nothing; ``1`` (``on``, ``true``, ``force``)
    samples every visible card; the default ``auto`` samples only the
    cards this process already holds a CUDA context on and never makes
    one, since a context costs the user's job hundreds of MB of card
    memory (the reference's ``JAX_PLATFORMS`` gate, which keeps its
    sampler off a single-client chip). Each sampled card's used bytes are
    its total less its free bytes (``torch.cuda.mem_get_info``: every
    process's use, as the card sees it). Any failure degrades to "no
    accelerator numbers" rather than an error. Keys: ``accel_count``
    (the visible cards), ``accel_mem_used_bytes``,
    ``accel_mem_total_bytes`` (over the sampled cards) and
    ``accel_mem_util``."""
    mode = os.environ.get(ACCEL_SAMPLING_ENV, 'auto').strip().lower()
    if mode in ('0', 'off', 'false', 'disabled'):
        return {}
    force = mode in ('1', 'on', 'true', 'force')
    if not force and not torch.cuda.is_initialized():
        return {}
    try:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    except RuntimeError:
        return {}
    used = total = 0.0
    seen = 0
    for index in range(count):
        if not force and not _has_context(index):
            continue
        try:
            free, card_total = torch.cuda.mem_get_info(index)
        except RuntimeError:
            continue
        used += float(card_total - free)
        total += float(card_total)
        seen += 1
    if not seen or total <= 0:
        return {}
    return {'accel_count': float(count),
            'accel_mem_used_bytes': used,
            'accel_mem_total_bytes': total,
            'accel_mem_util': min(max(used / total, 0.0), 1.0)}
