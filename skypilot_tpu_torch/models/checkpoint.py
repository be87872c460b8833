"""Checkpoints: save, list, restore — the trainer's preemption resume and
the replica's weights.

Counterpart of ``skypilot_tpu/models/checkpoint.py`` with the same
``<root>/step_<N>`` naming, keep-N pruning at save time and resume from
the newest complete step. The format is the port's own (no orbax on the
card's host): ``torch.save`` files written into a temporary directory,
a commit marker written last, then one rename into place, so an
interrupted save is never restored. The trainer saves its ``TrainState``
(params, Adam moments, count and step: :func:`save`, :func:`restore`,
:func:`restore_latest`); a replica's weights are a params tree
(:func:`save_params`), restored into a template tree
(:func:`restore_latest_params`) that must match the saved tree's keys,
shapes and dtypes, or ``ValueError``, as orbax raises in the reference.
So a trainer checkpoint handed to a replica raises, in both packages.
Reading the JAX package's orbax checkpoints is not ported.

A ``TrainState`` saves in a sharded format, on one device or on a
training mesh (``parallel/mesh.py``), as the reference's orbax save has
"no host gather" and every host writing its own shards: each rank
writes only its own slices of params, ``mu`` and ``nu`` to a file of
its own (a slice that several ranks hold, replicated along an axis its
spec does not name, by one of them), rank 0 writes ``index.json`` (each
leaf's global shape, dtype and pieces with their offsets, computed from
the mesh's layout, not gathered) and then the commit marker, once every
rank's file is on disk. :func:`restore` reads, on each rank, only the
pieces that overlap its own slices, so any mesh (or one device) resumes
any other's checkpoint, as orbax reshards into any abstract state. The
tree is any params-shaped tree whose specs :func:`train.specs_of`
knows (llama's, the MoE's). Step directories in the earlier one-file
format (``state.pt``: the whole state) still restore.
"""
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.device import resolve_device

STEP_PREFIX = 'step_'
STATE_FILE = 'state.pt'
INDEX_FILE = 'index.json'
COMMIT_FILE = 'commit.json'
SHARDED_FORMAT = 'sharded-1'


def _root(root: str) -> str:
    return os.path.abspath(os.path.expanduser(root))


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f'{STEP_PREFIX}{step}')


def _is_complete(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, COMMIT_FILE)) and
            (os.path.isfile(os.path.join(path, INDEX_FILE)) or
             os.path.isfile(os.path.join(path, STATE_FILE))))


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


def _durable(path: str, write) -> None:
    """``write(f)`` into a new file at ``path``, flushed to disk."""
    with open(path, 'wb') as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _commit(root: str, tmp: str, step: int, keep: int) -> str:
    """Write the commit marker into ``tmp``, rename it into place as
    step ``step`` and prune to the newest ``keep``."""
    _durable(os.path.join(tmp, COMMIT_FILE),
             lambda f: f.write(json.dumps({'step': step}).encode()))
    path = _ckpt_dir(root, step)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    _prune(root, keep)
    return path


def _write(root: str, obj: Any, step: int, keep: int) -> str:
    """``obj`` as step ``step`` under root in one file, committed by one
    rename; prune to the newest ``keep``."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f'.{STEP_PREFIX}{step}.tmp-{os.getpid()}')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, STATE_FILE))
    return _commit(root, tmp, step, keep)


def _leaves(tree, prefix: str) -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict in sorted order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _leaves(tree[k], f'{prefix}/{k}')]
    return [(prefix, tree)]


def _named_axes(spec) -> Tuple[str, ...]:
    return tuple(a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry))


def _pieces(mesh, shape, spec) -> List[Tuple[int, List[int], List[int]]]:
    """(mesh rank, start, shape) of every rank that writes a slice of a
    ``shape`` leaf under ``spec``: each distinct slice once, by the rank
    at coordinate 0 of every mesh axis the spec does not name. Computed
    from the mesh's layout alone."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if mesh is None:
        return [(0, [0] * len(shape), list(shape))]
    named = _named_axes(spec)
    out = []
    for r in range(mesh.num_ranks):
        view = mesh_lib.Mesh(mesh.shape, r)
        if view.coord(tuple(a for a in mesh.shape if a not in named)):
            continue
        slices = mesh_lib.spec_to_slices(shape, spec, view)
        out.append((r, [s.start for s in slices],
                    [s.stop - s.start for s in slices]))
    return out


def _global_shape(mesh, local, spec) -> List[int]:
    return [n * (1 if mesh is None or axes is None else mesh.size(axes))
            for n, axes in zip(local.shape,
                               tuple(spec) + (None,) * local.dim())]


def _rank_file(rank: int) -> str:
    return f'rank_{rank:05d}.pt'


def save(root: str, state: Any, step: int, keep: int = 3,
         mesh=None) -> str:
    """Write ``state`` (a ``train.TrainState``) as step ``step`` under
    root in the sharded format; prune to the newest ``keep``. With a
    ``mesh`` every rank of it calls this with its slices and returns once
    the step is committed. No rank gathers another's slices: each writes
    its own (a replicated slice by one rank), rank 0 the index from the
    mesh's layout, then the commit marker after every rank's file is on
    disk (:meth:`Mesh.barrier`)."""
    from skypilot_tpu_torch.models import train
    if (mesh is not None and mesh.num_ranks > 1 and
            not dist.is_initialized()):
        raise ValueError(f'a save on {mesh} needs every rank of it (a '
                         'process group)')
    opt = state.opt_state
    specs = train.specs_of(state.params)
    spec_of = dict(_leaves(specs, ''))
    rank = 0 if mesh is None else mesh.rank
    root = _root(root)
    tmp = os.path.join(root, f'.{STEP_PREFIX}{step}.tmp-sharded')
    if rank == 0:
        os.makedirs(root, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    leaves, index = {}, {}
    for name, tree in (('params', state.params), ('mu', opt.mu),
                       ('nu', opt.nu)):
        for path, local in _leaves(tree, ''):
            spec = spec_of[path]
            shape = _global_shape(mesh, local, spec)
            pieces = _pieces(mesh, shape, spec)
            key = f'{name}{path}'
            if any(r == rank for r, _, _ in pieces):
                leaves[key] = local.detach()
            index[key] = dict(
                shape=shape, dtype=str(local.dtype).split('.')[-1],
                pieces=[dict(file=_rank_file(r), start=start, shape=sh)
                        for r, start, sh in pieces])
    if mesh is not None:
        mesh.barrier()  # the directory exists
    if leaves:
        _durable(os.path.join(tmp, _rank_file(rank)),
                 lambda f: torch.save(leaves, f))
    del leaves
    if mesh is not None:
        mesh.barrier()  # every rank's file is on disk
    path = _ckpt_dir(root, step)
    if rank == 0:
        _durable(os.path.join(tmp, INDEX_FILE), lambda f: f.write(
            json.dumps(dict(format=SHARDED_FORMAT, step=state.step,
                            count=opt.count, leaves=index)).encode()))
        path = _commit(root, tmp, step, keep)
    if mesh is not None:
        mesh.barrier()  # committed
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


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """'a/b/c' keys to nested dicts."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _read_sharded(path: str, mesh, device) -> Any:
    """This rank's slices of a sharded step directory: each leaf's
    slice filled from the saved pieces that overlap it, reading only
    the files that hold one (memory-mapped, so only the overlapping
    bytes are read)."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    with open(os.path.join(path, INDEX_FILE), encoding='utf-8') as f:
        index = json.load(f)
    if index.get('format') != SHARDED_FORMAT:
        raise ValueError(f'{path}: unknown checkpoint format '
                         f'{index.get("format")!r}')
    entries = index['leaves']
    specs = train.specs_of(_nest({k[len('params/'):]: None
                                  for k in entries
                                  if k.startswith('params/')}))
    spec_of = dict(_leaves(specs, ''))
    files: Dict[str, Any] = {}
    flat = {}
    for key, entry in entries.items():
        leaf = key.split('/', 1)[1]
        shape = entry['shape']
        mine = (tuple(slice(0, n) for n in shape) if mesh is None else
                mesh_lib.spec_to_slices(shape, spec_of[f'/{leaf}'], mesh))
        out = torch.empty([s.stop - s.start for s in mine],
                          dtype=getattr(torch, entry['dtype']),
                          device=device)
        for piece in entry['pieces']:
            lo = [max(s.start, a) for s, a in zip(mine, piece['start'])]
            hi = [min(s.stop, a + n) for s, a, n in
                  zip(mine, piece['start'], piece['shape'])]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            if piece['file'] not in files:
                files[piece['file']] = torch.load(
                    os.path.join(path, piece['file']), map_location='cpu',
                    weights_only=True, mmap=True)
            src = files[piece['file']][key]
            dst = out
            for dim, (a, b, s, p) in enumerate(zip(lo, hi, mine,
                                                  piece['start'])):
                src = src.narrow(dim, a - p, b - a)
                dst = dst.narrow(dim, a - s.start, b - a)
            dst.copy_(src)
        flat[key] = out
    tree = _nest(flat)
    return train.TrainState(
        params=tree['params'],
        opt_state=train.AdamState(count=index['count'], mu=tree['mu'],
                                  nu=tree['nu']),
        step=index['step'])


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
    if os.path.isfile(os.path.join(path, INDEX_FILE)):
        state = _read_sharded(path, mesh, device)
    else:  # the one-file format: the whole state
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location='cpu', weights_only=True,
                           mmap=True)
        state = train.shard_state(train.TrainState(
            params=saved['params'],
            opt_state=train.AdamState(count=saved['count'],
                                      mu=saved['mu'], nu=saved['nu']),
            step=saved['step']), mesh, device)
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
    from skypilot_tpu_torch.models import moe, train
    model = train.model_of(model_cfg)
    specs = model.param_partition_specs(model_cfg)

    def meta(name, shape):
        # The MoE's router is fp32 (moe.init_params).
        dtype = (torch.float32 if model is moe and name == 'router' else
                 model_cfg.dtype)
        return torch.empty(shape, dtype=dtype, device='meta')

    params = {}
    for name, shape in model.param_shapes(model_cfg).items():
        params[name] = ({n: meta(n, sh) for n, sh in shape.items()}
                        if isinstance(shape, dict) else meta(name, shape))
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
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise ValueError(f'{path}: the saved tree does not match the '
                         'template: a trainer checkpoint (params, mu, '
                         'nu in shards), not a params tree')
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
