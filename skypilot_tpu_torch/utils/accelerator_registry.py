"""Per-card peak bf16 FLOPs for MFU.

This package's copy of the peak table of
``skypilot_tpu/utils/accelerator_registry.py``, for NVIDIA cards: the
``skytpu_train_mfu`` gauge (``observability/runtime_metrics.py``) and the
chip smoke read :func:`peak_bf16_flops` instead of keeping their own.
"""
from typing import Union

import torch

# Dense bf16 tensor-core peaks by ``torch.cuda.get_device_name`` (NVIDIA
# H100 Tensor Core GPU data sheet; half its with-sparsity figures).
NVIDIA_PEAK_BF16_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,    # H100 SXM5
    'NVIDIA H100 NVL': 835e12,
    'NVIDIA H100 PCIe': 756e12,
}


def peak_bf16_flops(device_or_name: Union[torch.device, str]) -> float:
    """Peak bf16 FLOPs/sec of a torch device (``'cuda'``, ``'cuda:1'``)
    or a card's name as ``torch.cuda.get_device_name`` gives it. 0.0
    for the CPU and for an unknown card, so callers skip the MFU instead
    of reporting garbage."""
    name = device_or_name
    if isinstance(name, str):
        try:
            name = torch.device(name)
        except RuntimeError:    # not a device string: a card's name
            pass
    if isinstance(name, torch.device):
        if name.type != 'cuda':
            return 0.0
        name = torch.cuda.get_device_name(name)
    return NVIDIA_PEAK_BF16_FLOPS.get(name, 0.0)
