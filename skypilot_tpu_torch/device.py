"""The device an entry point runs on: CUDA unless the caller names
another. No silent CPU fallback: without a card, only ``device='cpu'``
runs."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--device cpu) to run on "
                               "the CPU")
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{device} requested but CUDA is not available')
    return device
