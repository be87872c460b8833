"""Train-state checkpoints: save, list, restore — the preemption resume.

Counterpart of ``skypilot_tpu/models/checkpoint.py`` with the same
``<root>/step_<N>`` naming, keep-N pruning at save time and resume from
the newest complete step. The format is the port's own (no orbax on the
card's host): ``torch.save`` of params, Adam moments, count and step into
a temporary directory, a commit marker written last, then one rename
into place, so an interrupted save is never resumed from. Reading the
JAX package's orbax checkpoints is not ported.
"""
import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import torch

from skypilot_tpu_torch.device import resolve_device

STEP_PREFIX = 'step_'
STATE_FILE = 'state.pt'
COMMIT_FILE = 'commit.json'


def _root(root: str) -> str:
    return os.path.abspath(os.path.expanduser(root))


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f'{STEP_PREFIX}{step}')


def _is_complete(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, COMMIT_FILE)) and
            os.path.isfile(os.path.join(path, STATE_FILE)))


def list_steps(root: str) -> List[int]:
    """Completed checkpoint steps under root, ascending."""
    root = _root(root)
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(f'{STEP_PREFIX}(\\d+)', name)
        if m and _is_complete(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def save(root: str, state: Any, step: int, keep: int = 3) -> str:
    """Write ``state`` (a ``train.TrainState``) as step ``step`` under
    root; prune to the newest ``keep``."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f'.{STEP_PREFIX}{step}.tmp-{os.getpid()}')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    opt = state.opt_state
    torch.save({'params': state.params, 'mu': opt.mu, 'nu': opt.nu,
                'count': opt.count, 'step': state.step},
               os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, COMMIT_FILE), 'w', encoding='utf-8') as f:
        json.dump({'step': step}, f)
    path = _ckpt_dir(root, step)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    _prune(root, keep)
    return path


def _prune(root: str, keep: int) -> None:
    steps = list_steps(root)
    for step in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(root, step), ignore_errors=True)


def restore(root: str, step: int, device=None) -> Any:
    """The ``train.TrainState`` saved at ``step``, on ``device``
    (default CUDA; without a card only ``device='cpu'`` runs)."""
    from skypilot_tpu_torch.models import train
    device = resolve_device(device)
    path = _ckpt_dir(_root(root), step)
    if not _is_complete(path):
        raise FileNotFoundError(f'no complete checkpoint at {path}')
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                       weights_only=True)
    return train.TrainState(
        params=saved['params'],
        opt_state=train.AdamState(count=saved['count'], mu=saved['mu'],
                                  nu=saved['nu']),
        step=saved['step'])


def restore_latest(root: str, device=None) -> Optional[Tuple[Any, int]]:
    """(state, step) from the newest complete checkpoint, or None."""
    steps = list_steps(root)
    if not steps:
        return None
    return restore(root, steps[-1], device), steps[-1]
