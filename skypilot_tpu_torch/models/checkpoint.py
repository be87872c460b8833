"""Checkpoints: save, list, restore — the trainer's preemption resume and
the replica's weights.

Counterpart of ``skypilot_tpu/models/checkpoint.py`` with the same
``<root>/step_<N>`` naming, keep-N pruning at save time and resume from
the newest complete step. The format is the port's own (no orbax on the
card's host): ``torch.save`` of one object into a temporary directory, a
commit marker written last, then one rename into place, so an
interrupted save is never restored. The trainer saves its ``TrainState``
(params, Adam moments, count and step: :func:`save`, :func:`restore`,
:func:`restore_latest`); a replica's weights are a params tree
(:func:`save_params`), restored into a template tree
(:func:`restore_latest_params`) that must match the saved tree's keys,
shapes and dtypes, or ``ValueError``, as orbax raises in the reference.
So a trainer checkpoint handed to a replica raises, in both packages.
Reading the JAX package's orbax checkpoints is not ported.

A sharded ``TrainState`` (on a training mesh, ``parallel/mesh.py``)
saves in the one-device format, so every mesh resumes every other
mesh's checkpoint, as orbax reshards into any abstract state in the
reference: :func:`save` gathers leaf by leaf and rank 0 writes (the
commit marker last), and :func:`restore` slices each leaf to the
restoring rank's shard.
"""
import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

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


def _write(root: str, obj: Any, step: int, keep: int) -> str:
    """``obj`` as step ``step`` under root, committed by one rename;
    prune to the newest ``keep``."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f'.{STEP_PREFIX}{step}.tmp-{os.getpid()}')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, COMMIT_FILE), 'w', encoding='utf-8') as f:
        json.dump({'step': step}, f)
    path = _ckpt_dir(root, step)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    _prune(root, keep)
    return path


def save(root: str, state: Any, step: int, keep: int = 3,
         mesh=None) -> str:
    """Write ``state`` (a ``train.TrainState``) as step ``step`` under
    root; prune to the newest ``keep``. With a ``mesh`` every rank calls
    it with its slices: each leaf is gathered in turn to rank 0's host
    (``train.gather_tree``: a layer-stacked leaf a layer at a time, so
    its card holds one layer whole; the host holds the whole state, as
    the one-file format writes it), rank 0 writes, and every rank
    returns once the step is committed."""
    opt = state.opt_state
    trees = {'params': state.params, 'mu': opt.mu, 'nu': opt.nu}
    if mesh is not None:
        from skypilot_tpu_torch.models import train
        trees = {k: train.gather_tree(t, mesh) for k, t in trees.items()}
    path = _ckpt_dir(_root(root), step)
    if mesh is None or mesh.rank == 0:
        path = _write(root, dict(trees, count=opt.count, step=state.step),
                      step, keep)
    if mesh is not None and dist.is_initialized():
        dist.barrier()
    return path


def save_params(root: str, params: Any, step: int, keep: int = 3) -> str:
    """Write a params tree (nested dicts of tensors) as step ``step``
    under root; prune to the newest ``keep``."""
    def check(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                check(v, f'{path}/{k}')
        elif not isinstance(node, torch.Tensor):
            raise TypeError(f'{path or "params"}: {type(node).__name__} '
                            'is not a tensor (save weights before '
                            'quantising them)')
    check(params, '')
    return _write(root, params, step, keep)


def _prune(root: str, keep: int) -> None:
    steps = list_steps(root)
    for step in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(root, step), ignore_errors=True)


def restore(root: str, step: int, device=None, mesh=None,
            abstract: Any = None) -> Any:
    """The ``train.TrainState`` saved at ``step``, on ``device``
    (default CUDA; without a card only ``device='cpu'`` runs). With a
    ``mesh``, this rank's slices of it. With ``abstract`` (from
    :func:`abstract_train_state`), a tree, shape or dtype that differs
    raises ValueError, as orbax raises."""
    from skypilot_tpu_torch.models import train
    device = resolve_device(device)
    path = _ckpt_dir(_root(root), step)
    if not _is_complete(path):
        raise FileNotFoundError(f'no complete checkpoint at {path}')
    saved = torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                       weights_only=True, mmap=True)
    state = train.TrainState(
        params=saved['params'],
        opt_state=train.AdamState(count=saved['count'], mu=saved['mu'],
                                  nu=saved['nu']),
        step=saved['step'])
    state = train.shard_state(state, mesh, device)
    if abstract is not None:
        for name, got, want in (
                ('params', state.params, abstract.params),
                ('mu', state.opt_state.mu, abstract.opt_state.mu),
                ('nu', state.opt_state.nu, abstract.opt_state.nu)):
            _match(got, want, name)
    return state


def restore_latest(root: str, device=None, mesh=None,
                   abstract: Any = None) -> Optional[Tuple[Any, int]]:
    """(state, step) from the newest complete checkpoint, or None (see
    :func:`restore`)."""
    steps = list_steps(root)
    if not steps:
        return None
    return restore(root, steps[-1], device, mesh, abstract), steps[-1]


def abstract_train_state(model_cfg, train_cfg, mesh=None) -> Any:
    """The ``train.TrainState`` that ``train.init_train_state`` makes,
    as tensors on the meta device (shapes and dtypes only): this rank's
    slices with a ``mesh``."""
    from skypilot_tpu_torch.models import llama, train
    specs = llama.param_partition_specs(model_cfg)
    meta = torch.device('meta')
    params = {}
    for name, shape in llama.param_shapes(model_cfg).items():
        params[name] = (
            {n: torch.empty(sh, dtype=model_cfg.dtype, device=meta)
             for n, sh in shape.items()} if isinstance(shape, dict) else
            torch.empty(shape, dtype=model_cfg.dtype, device=meta))
    if mesh is not None:
        params = _meta_shards(params, specs, mesh)
    opt = train.make_optimizer(train_cfg).init(params)
    return train.TrainState(params=params, opt_state=opt, step=0)


def _meta_shards(tree, specs, mesh):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if isinstance(tree, dict):
        return {k: _meta_shards(tree[k], specs[k], mesh) for k in tree}
    shape = [s.stop - s.start
             for s in mesh_lib.spec_to_slices(tree.shape, specs, mesh)]
    return torch.empty(shape, dtype=tree.dtype, device='meta')


def _match(saved: Any, template: Any, path: str) -> None:
    """Raise ValueError unless ``saved`` has the template's tree: the
    same dict keys, and tensors of the same shapes and dtypes."""
    where = path or 'params'
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            have = (sorted(saved) if isinstance(saved, dict)
                    else type(saved).__name__)
            raise ValueError(f'{where}: the saved tree does not match the '
                             f'template: {have} != {sorted(template)}')
        for k in template:
            _match(saved[k], template[k], f'{path}/{k}')
        return
    if not isinstance(saved, torch.Tensor):
        raise ValueError(f'{where}: saved {type(saved).__name__}, the '
                         'template has a tensor')
    if saved.shape != template.shape or saved.dtype != template.dtype:
        raise ValueError(f'{where}: saved {tuple(saved.shape)} '
                         f'{saved.dtype} != template '
                         f'{tuple(template.shape)} {template.dtype}')


def restore_latest_params(root: str, template: Any, device=None
                          ) -> Optional[Tuple[Any, int]]:
    """(params, step) from the newest complete checkpoint, restored into
    ``template``'s tree on ``device`` (default CUDA; without a card only
    ``device='cpu'`` runs), or None when there is no complete step.
    Raises ValueError when the saved tree is not the template's (a
    trainer checkpoint, another config). The reference's
    ``restore_latest(root, params)`` as the replica calls it."""
    device = resolve_device(device)
    steps = list_steps(root)
    if not steps:
        return None
    path = _ckpt_dir(_root(root), steps[-1])
    # Memory-mapped: the tree is checked before any tensor is read or
    # moved to the device.
    saved = torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                       weights_only=True, mmap=True)
    _match(saved, template, '')

    def to_device(node):
        if isinstance(node, dict):
            return {k: to_device(v) for k, v in node.items()}
        return node.to(device)

    return to_device(saved), steps[-1]
