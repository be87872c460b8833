"""The mesh: which rank holds which slice, for training and for serving.

Counterpart of ``skypilot_tpu/parallel/mesh.py``. The reference lays
named axes over a device array and lets GSPMD insert the collectives;
here each device is a process (a rank of ``torch.distributed``) holding
contiguous slices, and the collectives are explicit.

**Training** (:class:`MeshConfig`, :func:`make_mesh`,
:func:`make_multislice_mesh`, :func:`batch_spec`): the axes
``(dcn,) + AXIS_ORDER`` with this rank's coordinate row-major over them,
as ``np.reshape`` orders the reference's devices, and one process group
per axis and per set of axes the train step reduces over
(:data:`GROUP_AXES`). Params are sliced by their specs
(:func:`shard_tensor`, :func:`shard_params`, :func:`spec_to_slices`)
and gathered back to rank 0 (:meth:`Mesh.gather_to_root`). The
collectives GSPMD inserts into the reference's train step are the
autograd functions at the end of this module: :func:`gather_shards`
(FSDP: an all-gather of a param's fsdp slices before use, a
reduce-scatter of its grad, then the sum over the replica axes),
:func:`copy_to_model` and :func:`reduce_from_model` (Megatron's column-
and row-parallel pair; :func:`copy_to` and :func:`reduce_from` over any
axes, as the MoE's 'expert' region and GPipe's 'stage' output) and
:func:`sum_over` (a sum whose every rank's use is its own, as sync batch
norm's statistics). Beside them: :func:`gather_rows` (every batch
rank's rows, the grad reduce-scattered back), :func:`ppermute` (a ring
shift by point-to-point sends, the backward shifting the other way:
ring attention's K/V, GPipe's activations through
:meth:`Mesh.ppermute`) and :func:`shard`/:func:`unshard` (a whole
tensor every rank holds to this rank's shard under a spec, and back).
The 'seq' and 'expert' axes are replicated compute for a llama model:
the batch splits over (dcn, data, fsdp) only and no llama param names
them, so no sum runs over either. Every sum runs in
fp32 and rounds back to the tensor's dtype, as in the
reference's compiled program on the 8-device CPU mesh, whose
all-reduces and reduce-scatters are all fp32.

**Serving** (``serving_mesh``'s validation as :func:`serving_devices`,
``serving_param_specs``, ``kv_cache_spec``, ``shard_serving_params``):
a ``'model'`` axis over ``tp`` ranks; the row-parallel products and the
vocab-sharded logits carry their own collectives (:class:`RowParallel`,
:class:`VocabParallel`, over a ``parallel/tp.TPGroup``).

A spec is a tuple with one entry a dim: an axis name (or a tuple of
names, major first) on the dim that splits into contiguous slices, None
elsewhere (the reference's ``PartitionSpec``). Megatron-style: wq/wk/wv/
w1/w3 split their output columns over ``'model'``, wo/w2 their
contraction rows, ``lm_head`` its vocab columns; in training the other
dim of each weight splits over ``'fsdp'``. Query heads are grouped
kv-head-major (head ``kv * G + r``), so a contiguous split of wq's
columns keeps each GQA group with its K/V head: rank ``r`` holds KV
heads ``[r * Hkv/tp, (r+1) * Hkv/tp)`` and their query heads.
"""
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch.ops import quant

DATA_AXIS = 'data'
FSDP_AXIS = 'fsdp'
EXPERT_AXIS = 'expert'
MODEL_AXIS = 'model'
SEQ_AXIS = 'seq'
# Multislice: the slice axis, leading. Only the batch splits over it, so
# the one collective that crosses it is the gradients' sum.
DCN_AXIS = 'dcn'
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)
# The batch splits over these (batch_spec); params replicate over the
# replica axes and split over the param axes.
BATCH_AXES = (DCN_AXIS, DATA_AXIS, FSDP_AXIS)
REPLICA_AXES = (DCN_AXIS, DATA_AXIS)
PARAM_AXES = (FSDP_AXIS, MODEL_AXIS)
# A pipeline mesh's layer axis (``parallel/pipeline.make_pp_mesh``).
STAGE_AXIS = 'stage'
# The axes an expert weight splits over (``models/moe.py``), and those
# its experts' partial outputs are summed over.
EXPERT_PARAM_AXES = (FSDP_AXIS, EXPERT_AXIS, MODEL_AXIS)
EXPERT_REGION_AXES = (EXPERT_AXIS, MODEL_AXIS)
# The sets of axes a train step reduces over: a process group each (over
# the axes of more than one rank the mesh has).
GROUP_AXES = tuple(
    (a,) for a in (DCN_AXIS,) + AXIS_ORDER + (STAGE_AXIS,)) + (
        BATCH_AXES, REPLICA_AXES, PARAM_AXES, EXPERT_PARAM_AXES,
        EXPERT_REGION_AXES)
BACKENDS = ('nccl', 'gloo')
Axes = Union[str, Tuple[str, ...]]


# ---------------------------------------------------------------- training


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Named axis sizes; -1 on at most one axis is inferred from the
    rank count."""
    data: int = 1
    fsdp: int = -1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def resolve(self, num_devices: int) -> Dict[str, int]:
        sizes = {
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            EXPERT_AXIS: self.expert,
            SEQ_AXIS: self.seq,
            MODEL_AXIS: self.model,
        }
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f'Only one axis may be -1, got {unknown}')
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if num_devices % known:
                raise ValueError(
                    f'{num_devices} devices not divisible by fixed axes '
                    f'{sizes}')
            sizes[unknown[0]] = num_devices // known
        if math.prod(sizes.values()) != num_devices:
            raise ValueError(
                f'Mesh {sizes} does not cover {num_devices} devices.')
        return sizes


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """One rank's view of a training mesh: the axis sizes (``shape``, in
    mesh order), this rank's coordinate on each, and the process groups
    of :data:`GROUP_AXES` that hold it (those of more than one rank). A
    mesh made without a process group is a layout only: its shapes,
    coordinates and slices, no collectives.

    The collectives take the axes to reduce or gather over (a name or a
    tuple of names); over axes of size 1 they return their input. CUDA
    tensors over a gloo group go through host copies (two ranks on one
    card; NCCL refuses a repeated card)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Optional[Dict[frozenset, Any]] = None):
        self.shape = dict(shape)
        self.rank = rank
        self.num_ranks = math.prod(self.shape.values())
        if not 0 <= rank < self.num_ranks:
            raise ValueError(f'rank {rank} is outside a mesh of '
                             f'{self.num_ranks} ranks')
        self.coords = dict(zip(self.shape, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))
        self._groups = dict(groups or {})
        self.backend = (dist.get_backend() if self._groups else None)

    def __repr__(self) -> str:
        return f'Mesh({self.shape}, rank={self.rank})'

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axes: Axes) -> int:
        """The ranks along ``axes`` (an absent axis counts 1)."""
        return math.prod(self.shape.get(a, 1) for a in _axes(axes))

    def coord(self, axes: Axes) -> int:
        """This rank's index along ``axes``, row-major over them."""
        index = 0
        for a in _axes(axes):
            index = index * self.shape.get(a, 1) + self.coords.get(a, 0)
        return index

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` under
        :func:`batch_spec`."""
        parts = self.size(BATCH_AXES)
        if n % parts:
            raise ValueError(f'a global batch of {n} does not split over '
                             f'the {parts} batch ranks of {self}')
        size = n // parts
        start = self.coord(BATCH_AXES) * size
        return slice(start, start + size)

    # ----------------------------------------------------- collectives

    def _group(self, axes: Axes):
        key = frozenset(a for a in _axes(axes) if self.shape.get(a, 1) > 1)
        if not key:
            return None
        if key not in self._groups:
            raise ValueError(f'{self} has no process group over {axes}')
        return self._groups[key]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collective reads it: on the host for CUDA
        tensors over gloo."""
        if t.is_cuda and self.backend == 'gloo':
            return t.detach().cpu()
        return t.detach()

    @staticmethod
    def _exchange(group, chunks: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
        """One all-to-all: ``chunks[j]`` (equal sizes) to the group's
        j-th rank; returns the chunk received from each rank, in rank
        order, flat."""
        send = torch.cat([c.reshape(-1) for c in chunks])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.chunk(len(chunks))

    @staticmethod
    def _sum(parts: Sequence[torch.Tensor], dtype) -> torch.Tensor:
        """The parts summed in fp32 in rank order, rounded once to
        ``dtype``."""
        total = parts[0].float()
        for part in parts[1:]:
            total = total + part.float()
        return total.to(dtype)

    def all_reduce(self, t: torch.Tensor, axes: Axes,
                   op: str = 'sum') -> torch.Tensor:
        """``t`` summed (``op`` 'sum') or maxed ('max') over the ranks
        along ``axes``, in fp32, as a new tensor of t's dtype. A sum is a
        reduce-scatter and an all-gather of t's chunks by all-to-all:
        each rank sums its chunk of every rank's values in fp32 and
        rounds it once, so every rank gets the same bits, and the wire
        carries t's dtype (on the card's host this beat gloo's fp32
        all-reduce and reduce-scatter in phase 19: PERF.md section 6)."""
        group = self._group(axes)
        if group is None:
            return t
        if op == 'max':
            buf = self._wire(t).to(torch.float32, copy=True).contiguous()
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
            return buf.to(t.device, t.dtype)
        if op != 'sum':
            raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
        n = self.size(axes)
        flat = self._wire(t).reshape(-1)
        pad = -flat.numel() % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        mine = self._sum(self._exchange(group, flat.chunk(n)), t.dtype)
        whole = torch.cat(self._exchange(group, [mine] * n))
        return whole[:t.numel()].reshape(t.shape).to(t.device)

    def all_gather(self, t: torch.Tensor, axes: Axes,
                   dim: int) -> torch.Tensor:
        """The slices of ``t`` along ``axes`` concatenated on ``dim`` in
        rank order."""
        group = self._group(axes)
        if group is None:
            return t
        buf = self._wire(t).contiguous()
        out = buf.new_empty((self.size(axes) * buf.numel(),))
        dist.all_gather_into_tensor(out, buf.reshape(-1), group=group)
        return torch.cat(out.view(-1, *buf.shape).unbind(0),
                         dim=dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, axes: Axes, dim: int,
                       dtype=None) -> torch.Tensor:
        """``t`` summed over the ranks along ``axes`` in fp32, and this
        rank's contiguous slice of the sum on ``dim``, rounded once to
        ``dtype`` (default t's); by all-to-all, as :meth:`all_reduce`'s
        sum, the wire carrying t's dtype."""
        group = self._group(axes)
        if group is None:
            return t if dtype is None else t.to(dtype)
        n = self.size(axes)
        chunks = self._wire(t).movedim(dim, 0).chunk(n)
        if len(chunks) != n or chunks[-1].shape != chunks[0].shape:
            raise ValueError(f'dim of {t.shape[dim]} does not split over '
                             f'the {n} ranks of {axes}')
        parts = [p.view(chunks[0].shape)
                 for p in self._exchange(group, chunks)]
        return self._sum(parts, dtype or t.dtype).movedim(0, dim).to(
            t.device)

    def ppermute(self, t: torch.Tensor, axis: str,
                 shift: int = 1) -> torch.Tensor:
        """The ring shift along ``axis``: ``t`` goes to the rank ``shift``
        places on (cyclic), and the tensor of the rank ``shift`` places
        back is returned (the reference's ``lax.ppermute`` with the
        permutation ``i -> i + shift``), by one send and one receive."""
        group = self._group(axis)
        if group is None:
            return t
        n, i = self.size(axis), self.coord(axis)
        buf = self._wire(t).contiguous()
        out = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf,
                          dist.get_global_rank(group, (i + shift) % n),
                          group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (i - shift) % n),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)

    def barrier(self) -> None:
        """Return once every rank of the mesh has called it: a barrier
        over each axis in turn (the last axis's returns only after every
        rank on its line passed the earlier axes', which waited for
        theirs, so every rank of the grid has arrived)."""
        for axis in self.shape:
            group = self._group(axis)
            if group is not None:
                dist.barrier(group=group)

    def gather_to_root(self, x: torch.Tensor,
                       spec: Tuple) -> Optional[torch.Tensor]:
        """The whole tensor from every rank's shard under ``spec``, on
        rank 0 alone (None elsewhere; every rank calls it): each sharded
        dim is gathered in turn to its axes' first rank, and the replicas
        (the ranks off 0 on an axis the spec does not name) take no
        part."""
        named = [a for axes in spec if axes is not None
                 for a in _axes(axes)]
        if self.coord(tuple(a for a in self.shape if a not in named)):
            return None  # a replica of a rank that takes part
        done: Tuple[str, ...] = ()
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            if self.coord(done):
                return None
            group = self._group(axes)
            done += _axes(axes)
            if group is None:
                continue
            buf = self._wire(x).contiguous()
            root = self.coord(axes) == 0
            parts = ([torch.empty_like(buf) for _ in range(self.size(axes))]
                     if root else None)
            dist.gather(buf, parts, dst=dist.get_global_rank(group, 0),
                        group=group)
            if not root:
                return None
            x = torch.cat(parts, dim=dim)
        return x if self.rank == 0 else None


def _form_groups(ids: np.ndarray, names: Sequence[str], rank: int
                 ) -> Dict[frozenset, Any]:
    """Every group of :data:`GROUP_AXES` over more than one rank of the
    mesh ``ids`` (global ranks laid out on the axes ``names``), made by
    every rank of the process group in the same order
    (``dist.new_group`` is collective); returns the ones that hold
    ``rank``."""
    out = {}
    done = set()
    for axes in GROUP_AXES:
        axes = tuple(a for a in axes
                     if a in names and ids.shape[names.index(a)] > 1)
        if not axes or frozenset(axes) in done:
            continue
        done.add(frozenset(axes))
        inner = [names.index(a) for a in axes]
        size = math.prod(ids.shape[i] for i in inner)
        outer = [i for i in range(len(names)) if i not in inner]
        for ranks in ids.transpose(outer + inner).reshape(-1, size).tolist():
            group = dist.new_group(ranks)
            if rank in ranks:
                out[frozenset(axes)] = group
    return out


def _span(ranks: Optional[Sequence[int]]) -> List[int]:
    """The global ranks a mesh spans: ``ranks``, by default every rank
    of the process group (one rank without one)."""
    if ranks is not None:
        return list(ranks)
    return list(range(dist.get_world_size() if dist.is_initialized()
                      else 1))


def _build(shape: Dict[str, int], ranks: List[int],
           rank: Optional[int]) -> Optional[Mesh]:
    """The mesh of ``shape`` over ``ranks`` as seen from global rank
    ``rank``: with a process group, its groups formed (every rank of the
    group calls this) and None on a rank outside the mesh; without one,
    a layout."""
    if not dist.is_initialized():
        return Mesh(shape, ranks.index(rank or 0))
    if rank not in (None, dist.get_rank()):
        raise ValueError(f'this process is rank {dist.get_rank()}, not '
                         f'{rank}')
    me = dist.get_rank()
    ids = np.asarray(ranks).reshape(tuple(shape.values()))
    groups = _form_groups(ids, tuple(shape), me)
    return Mesh(shape, ranks.index(me), groups) if me in ranks else None


def build_mesh(shape: Dict[str, int],
               ranks: Optional[Sequence[int]] = None,
               rank: Optional[int] = None) -> Optional[Mesh]:
    """A mesh of the named axes ``shape`` (in order, the last innermost)
    over ``ranks``; ``ranks`` and ``rank`` as :func:`make_mesh`'s."""
    ranks = _span(ranks)
    if math.prod(shape.values()) != len(ranks):
        raise ValueError(f'{len(ranks)} devices != {shape}')
    return _build(dict(shape), ranks, rank)


def make_mesh(config: Optional[MeshConfig] = None,
              ranks: Optional[Sequence[int]] = None,
              rank: Optional[int] = None) -> Optional[Mesh]:
    """A mesh over ``ranks`` (the reference's ``devices``; default every
    rank of the default process group, each of which calls it), axes in
    :data:`AXIS_ORDER` so 'model' is innermost; None on a rank outside
    it. Without a process group, a layout seen from ``rank`` (default
    0). Default config: fsdp over every rank."""
    ranks = _span(ranks)
    sizes = (config or MeshConfig()).resolve(len(ranks))
    return _build({a: sizes[a] for a in AXIS_ORDER}, ranks, rank)


def make_multislice_mesh(num_slices: int,
                         per_slice: Optional[MeshConfig] = None,
                         ranks: Optional[Sequence[int]] = None,
                         rank: Optional[int] = None) -> Optional[Mesh]:
    """A ``('dcn',) + AXIS_ORDER`` mesh over ``num_slices`` slices: the
    leading 'dcn' axis is the slice index (ranks slice-major), and
    ``per_slice`` lays out each slice's ranks (default: fsdp over
    them). Only the batch splits over 'dcn' (:func:`batch_spec`).
    ``ranks`` and ``rank`` as :func:`make_mesh`'s."""
    ranks = _span(ranks)
    if len(ranks) % num_slices:
        raise ValueError(f'{len(ranks)} devices not divisible into '
                         f'{num_slices} slices')
    sizes = (per_slice or MeshConfig()).resolve(len(ranks) // num_slices)
    shape = {DCN_AXIS: num_slices}
    shape.update((a, sizes[a]) for a in AXIS_ORDER)
    return _build(shape, ranks, rank)


def batch_spec(multislice: bool = False) -> Tuple:
    """Activations: the batch split over data+fsdp (the standard
    recipe); multislice meshes add the leading 'dcn' slice axis."""
    if multislice:
        return ((DCN_AXIS, DATA_AXIS, FSDP_AXIS),)
    return ((DATA_AXIS, FSDP_AXIS),)


def batch_seq_spec() -> Tuple:
    """The batch over data+fsdp, the sequence over the seq axis."""
    return ((DATA_AXIS, FSDP_AXIS), SEQ_AXIS)


def spec_to_slices(shape: Sequence[int], spec: Tuple,
                   mesh: Mesh) -> Tuple[slice, ...]:
    """Where this rank's shard of a ``shape`` tensor under ``spec``
    lies (the reference's NamedSharding, as one slice a dim)."""
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axes is None:
            out.append(slice(0, n))
            continue
        parts = mesh.size(axes)
        if n % parts:
            raise ValueError(f'dim of {n} does not split over the {parts} '
                             f'ranks of {axes}')
        size = n // parts
        start = mesh.coord(axes) * size
        out.append(slice(start, start + size))
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec: Tuple, mesh: Mesh,
                 device=None) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec``: a new contiguous
    tensor (never x's storage, which the optimizer would then update in
    place) on ``device`` (default x's)."""
    for dim, s in enumerate(spec_to_slices(x.shape, spec, mesh)):
        if s.stop - s.start != x.shape[dim]:
            x = x.narrow(dim, s.start, s.stop - s.start)
    return x.to(device or x.device, copy=True).contiguous()


def shard_params(params, mesh: Mesh, specs, device=None):
    """:func:`shard_tensor` over a params tree and its specs tree."""
    if isinstance(specs, dict):
        return {k: shard_params(params[k], mesh, v, device)
                for k, v in specs.items()}
    return shard_tensor(params, specs, mesh, device)


# ------------------------------------- the collectives of the train step


class _GatherShards(torch.autograd.Function):
    """FSDP. Forward: the param's fsdp slices all-gathered on ``dim``.
    Backward: the grad reduce-scattered over fsdp and summed over the
    replica axes in fp32, then rounded once to the param's dtype: the
    grad of this rank's slice over the whole global batch."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, FSDP_AXIS, dim)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        g = ctx.mesh.reduce_scatter(grad, FSDP_AXIS, ctx.dim, torch.float32)
        g = ctx.mesh.all_reduce(g, REPLICA_AXES)
        return g.to(grad.dtype), None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f over ``axes``: the input of a region each rank of
    the axes computes a part of. Forward: identity; backward: the grad
    summed over ``axes``."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g over ``axes``: the parts of such a region. Forward:
    summed over ``axes``; backward: identity (every rank of the axes
    runs the same downstream)."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, axes):
        del ctx
        return mesh.all_reduce(x, axes)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return grad, None, None


class _SumOver(torch.autograd.Function):
    """A sum over ``axes`` whose result each rank uses on its own rows:
    forward and backward both sum."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x, axes)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axes), None, None


class _GatherRows(torch.autograd.Function):
    """The rows of every batch rank, in global order. Forward: the
    all-gather of dim 0 over :data:`BATCH_AXES`; backward: the grad
    summed over them and this rank's rows kept (every rank ran the same
    program on all the rows)."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(x, BATCH_AXES, 0)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter(grad, BATCH_AXES, 0), None


class _PPermute(torch.autograd.Function):
    """:meth:`Mesh.ppermute` of several tensors in one message; the
    backward runs the reverse ring."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, mesh, axis, shift, *xs):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift_all(xs, mesh, axis, shift)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, *grads):
        return (None, None, None) + _shift_all(grads, ctx.mesh, ctx.axis,
                                               -ctx.shift)


def _shift_all(xs, mesh: Mesh, axis: str, shift: int) -> tuple:
    flat = torch.cat([x.reshape(-1) for x in xs])
    got = mesh.ppermute(flat, axis, shift).split([x.numel() for x in xs])
    return tuple(g.view(x.shape) for g, x in zip(got, xs))


class _Shard(torch.autograd.Function):
    """This rank's shard of a tensor every rank holds whole, under
    ``spec``. Backward: the shards' grads gathered back to the whole
    tensor on every rank."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return shard_tensor(x, spec, mesh)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return _unshard(grad, ctx.mesh, ctx.spec), None, None


class _Unshard(torch.autograd.Function):
    """The whole tensor on every rank from the ranks' shards under
    ``spec``. Backward: this rank's shard of the grad (every rank holds
    the same grad of the whole)."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return _unshard(x, mesh, spec)

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        return shard_tensor(grad, ctx.spec, ctx.mesh), None, None


def _unshard(x: torch.Tensor, mesh: Mesh, spec: Tuple) -> torch.Tensor:
    for dim, axes in enumerate(spec):
        if axes is not None:
            x = mesh.all_gather(x, axes, dim)
    return x


def gather_shards(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """A param's fsdp slices gathered on ``dim`` for use (see
    :class:`_GatherShards`)."""
    return _GatherShards.apply(x, mesh, dim)


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return copy_to(x, mesh, MODEL_AXIS)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return reduce_from(x, mesh, MODEL_AXIS)


def sum_over(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _SumOver.apply(x, mesh, axes)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every batch rank's rows of ``x`` (dim 0), in global order (see
    :class:`_GatherRows`)."""
    return _GatherRows.apply(x, mesh)


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
             shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """:meth:`Mesh.ppermute` of each of ``xs`` (one message), with a
    backward that sends the grads the other way round the ring."""
    return _PPermute.apply(mesh, axis, shift, *xs)


def shard(x: torch.Tensor, mesh: Mesh, spec: Tuple) -> torch.Tensor:
    """This rank's shard of a whole tensor (see :class:`_Shard`)."""
    return _Shard.apply(x, mesh, spec)


def unshard(x: torch.Tensor, mesh: Mesh, spec: Tuple) -> torch.Tensor:
    """The whole tensor from the shards (see :class:`_Unshard`)."""
    return _Unshard.apply(x, mesh, spec)


# ----------------------------------------------------------------- serving


def serving_devices(tp: int, devices: Optional[Sequence] = None,
                    platform: str = 'cuda') -> List[torch.device]:
    """The device of each rank of a ``tp``-way serving group: the first
    ``tp`` of ``devices``, by default the visible cards (``platform``
    'cuda') or ``tp`` CPU ranks ('cpu'). Raises when tp < 1 or tp
    exceeds the devices given or the cards visible."""
    if tp < 1:
        raise ValueError(f'tp must be >= 1, got {tp}')
    if devices is None:
        if platform == 'cpu':
            devices = ['cpu'] * tp
        else:
            n = torch.cuda.device_count()
            if tp > n:
                raise ValueError(
                    f'tp={tp} exceeds the {n} visible card(s)')
            devices = [f'cuda:{i}' for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if tp > len(devices):
        raise ValueError(f'tp={tp} exceeds the {len(devices)} device(s) '
                         'given')
    return devices[:tp]


def check_backend(backend: str, devices: Sequence[torch.device]) -> None:
    """NCCL takes one card a rank; gloo takes CPU ranks, or CUDA ranks
    that may share a card (its collectives copy through the host)."""
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got '
                         f'{backend!r}')
    if backend == 'nccl':
        if any(d.type != 'cuda' for d in devices):
            raise ValueError(f'nccl needs a card a rank, got {devices}')
        if len({str(d) for d in devices}) < len(devices):
            raise ValueError(f'nccl needs a card of its own for each '
                             f'rank; {list(map(str, devices))} repeats '
                             "one (two ranks on one card take "
                             "backend='gloo')")


def serving_param_specs(cfg) -> dict:
    """The spec of each serving param (the reference's tree): layer
    weights are stacked ``[L, in, out]``."""
    del cfg
    col = (None, None, MODEL_AXIS)
    row = (None, MODEL_AXIS, None)
    rep2 = (None, None)
    return {
        'tok_embedding': rep2,
        'layers': {
            'attn_norm': rep2,
            'wq': col, 'wk': col, 'wv': col,
            'wo': row,
            'ffn_norm': rep2,
            'w1': col, 'w3': col,
            'w2': row,
        },
        'out_norm': (None,),
        'lm_head': (None, MODEL_AXIS),
    }


def kv_cache_spec() -> Tuple:
    """The pool's spec: ``[L, n_blocks, block_k, Hkv, hd]`` splits its
    KV-head dim, so each rank holds the K/V of the heads its wk/wv slice
    produces; the int8 scale planes drop the trailing hd."""
    return (None, None, None, MODEL_AXIS, None)


def split_range(n: int, rank: int, tp: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous ``[start, stop)`` of ``n`` items."""
    if n % tp:
        raise ValueError(f'{n} does not split {tp} ways')
    size = n // tp
    return rank * size, (rank + 1) * size


def _slice(x: torch.Tensor, spec: Tuple, rank: int, tp: int,
           device) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` under ``spec`` as a contiguous
    tensor on ``device``. A size-1 dim keeps no split: an int8 weight's
    ``[L, 1, out]`` scale under a row-parallel spec stays whole."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS and x.shape[dim] > 1:
            start, stop = split_range(x.shape[dim], rank, tp)
            x = x.narrow(dim, start, stop - start)
    return x.to(device).contiguous()


def _shard_leaf(x, spec: Tuple, rank: int, tp: int, device):
    if isinstance(x, quant.QuantizedTensor):
        # The int8 GEMM wants the values K-major (ops/quant.k_major).
        return quant.QuantizedTensor(
            values=quant.k_major(_slice(x.values, spec, rank, tp, device),
                                 1),
            scale=_slice(x.scale, spec, rank, tp, device))
    return _slice(x, spec, rank, tp, device)


def shard_serving_params(params, specs: dict, rank: int, tp: int,
                         device) -> dict:
    """Rank ``rank``'s slice of every param under ``specs`` (the
    reference's prefix-mapped specs: an int8 weight's values and scale
    share its spec, the size-1 rule applied per field), contiguous on
    ``device``, with no collective attached (:func:`wrap_serving_params`
    attaches them)."""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            out[name] = shard_serving_params(params[name], spec, rank, tp,
                                             device)
        else:
            out[name] = _shard_leaf(params[name], spec, rank, tp, device)
    return out


@dataclasses.dataclass(frozen=True)
class RowParallel:
    """A row-parallel weight's slice (wo, w2): this rank's rows of the
    contraction axis. ``x @ w`` multiplies the rank's slice of x and sums
    over the ranks at the point and in the dtype the reference's
    partitioned program does (read from its compiled HLO on the CPU
    mesh): a bf16 product is rounded to bf16 on each rank, summed in
    fp32 and rounded to bf16 again; an int8 product reduces its rows'
    amax by MAX before quantising and its int32 accumulator by an exact
    SUM before the rescale, so it is bit-equal to the unsharded one."""
    local: Any
    group: Any

    def __getitem__(self, i) -> 'RowParallel':
        return RowParallel(self.local[i], self.group)

    @property
    def nbytes(self) -> int:
        return self.local.nbytes

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.local, quant.QuantizedTensor):
            return quant.int8_matmul(x, self.local, group=self.group)
        partial = x @ self.local
        return self.group.all_reduce(partial.float()).to(partial.dtype)


@dataclasses.dataclass(frozen=True)
class VocabParallel:
    """The lm_head's vocab columns of this rank. ``x @ w`` all-gathers
    the ranks' logits into the full row, so greedy decoding takes the
    lowest index among equal maxima of the whole vocabulary, as argmax
    over an unsharded row does, and sampling sees every column."""
    local: torch.Tensor
    group: Any

    @property
    def nbytes(self) -> int:
        return self.local.nbytes

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.all_gather(x @ self.local, dim=-1)


ROW_PARALLEL = ('wo', 'w2')


def wrap_serving_params(shard: dict, group) -> dict:
    """Attach ``group``'s collectives to a rank's slice: wo/w2 become
    :class:`RowParallel`, lm_head :class:`VocabParallel`."""
    out = dict(shard)
    out['layers'] = {name: (RowParallel(w, group) if name in ROW_PARALLEL
                            else w)
                     for name, w in shard['layers'].items()}
    out['lm_head'] = VocabParallel(shard['lm_head'], group)
    return out


# --------------------------------------------------------------- the wire


def flatten(tree, prefix: str = '') -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a params tree in a fixed order (an int8
    weight is its ``.values`` and ``.scale``): what the TP group sends a
    worker."""
    out = []
    for name in sorted(tree):
        x = tree[name]
        path = f'{prefix}{name}'
        if isinstance(x, dict):
            out += flatten(x, path + '/')
        elif isinstance(x, quant.QuantizedTensor):
            out += [(path + '.values', x.values), (path + '.scale', x.scale)]
        else:
            out.append((path, x))
    return out


def unflatten(pairs: Sequence[Tuple[str, torch.Tensor]]) -> Dict:
    """The inverse of :func:`flatten`."""
    tree: Dict = {}
    quantized: Dict = {}
    for path, t in pairs:
        parts = path.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        if leaf.endswith(('.values', '.scale')):
            name, field = leaf.rsplit('.', 1)
            quantized.setdefault((id(node), name), (node, {}))[1][field] = t
        else:
            node[leaf] = t
    for (_, name), (node, fields) in quantized.items():
        node[name] = quant.QuantizedTensor(values=fields['values'],
                                           scale=fields['scale'])
    return tree
