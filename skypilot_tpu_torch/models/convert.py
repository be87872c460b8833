"""Bridge a parameter tree given as numpy arrays into the port, bit-exact.

The reference's params (``skypilot_tpu.models.llama.init_params``, or a
restored checkpoint) have the same tree and layout as the port's, so the
bridge is a copy per leaf. bf16 arrays arrive as ``ml_dtypes.bfloat16``
numpy arrays, which ``torch.from_numpy`` refuses; they are recognised by
dtype name and reinterpreted through ``uint16`` — the same 16 bits —
without importing ``ml_dtypes``.
"""
from typing import Any, Mapping

import numpy as np
import torch

from skypilot_tpu_torch.models import llama


def tensor_from_numpy(a, device='cpu') -> torch.Tensor:
    """One numpy array (bf16 via its bit pattern) → a torch tensor."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()    # torch.from_numpy shares memory it may write
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Mapping[str, Any], cfg: llama.LlamaConfig,
                      device='cpu') -> llama.Params:
    """Nested dict of numpy arrays → the port's params on ``device``.

    Every leaf must have the shape the config implies; a mismatch is a
    wrong-config bridge and raises instead of serving garbage."""
    def convert(node, shape, path):
        if isinstance(shape, dict):
            if set(node) != set(shape):
                raise ValueError(f'{path or "params"}: keys {sorted(node)} '
                                 f'!= {sorted(shape)}')
            return {k: convert(node[k], shape[k], f'{path}/{k}')
                    for k in shape}
        t = tensor_from_numpy(np.asarray(node), device)
        if tuple(t.shape) != shape:
            raise ValueError(f'{path}: shape {tuple(t.shape)} != {shape} '
                             f'for this config')
        return t

    return convert(tree, llama.param_shapes(cfg), '')
