"""Tensor-parallel serving layout: which rank holds which slice.

Counterpart of the serving half of ``skypilot_tpu/parallel/mesh.py``
(``serving_mesh``'s validation as :func:`serving_devices`,
``serving_param_specs``, ``kv_cache_spec``, ``shard_serving_params``).
The reference lays a GSPMD ``'model'`` axis
over ``tp`` devices and lets XLA insert the collectives; here each rank
is a process holding contiguous slices of the params and the pool, and
the row-parallel products and the vocab-sharded logits carry their own
collectives (:class:`RowParallel`, :class:`VocabParallel`, over a
``parallel/tp.TPGroup``).

A spec is a tuple with one entry a dim: :data:`MODEL_AXIS` on the dim
that splits into ``tp`` contiguous slices, None elsewhere (the
reference's ``PartitionSpec``). Megatron-style: wq/wk/wv/w1/w3 split
their output columns, wo/w2 their contraction rows, ``lm_head`` its
vocab columns, and the embedding and norms replicate. Query heads are
grouped kv-head-major (head ``kv * G + r``), so a contiguous split of
wq's columns keeps each GQA group with its K/V head: rank ``r`` holds KV
heads ``[r * Hkv/tp, (r+1) * Hkv/tp)`` and their query heads.
"""
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.ops import quant

MODEL_AXIS = 'model'
BACKENDS = ('nccl', 'gloo')


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
