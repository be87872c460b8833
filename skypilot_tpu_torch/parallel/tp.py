"""The tensor-parallel group of a serving replica: its processes, its
collectives and the worker loop.

The reference's TP replica is one SPMD program over a GSPMD mesh
(``skypilot_tpu/models/engine.py`` ``tp=``): XLA partitions each jitted
dispatch and inserts the collectives. Here TP is one process per rank
over ``torch.distributed``:

* **Rank 0** runs the model server, the scheduler, the block allocator
  and the radix cache (paging stays host-global, as in the reference:
  block tables are replicated and only the KV-head axis is split). Its
  :class:`~skypilot_tpu_torch.models.engine.DecodeEngine` sends every
  device operation to the workers (:meth:`TPGroup.post`) before it runs
  the operation on its own shard.
* **Ranks >= 1** run :func:`serve`: receive an operation, run it on
  their own shard (``models/engine.EngineShard``), and take part in the
  collectives the forward issues (``parallel/mesh.RowParallel``,
  ``VocabParallel``). Because every rank runs the same dispatches in
  the same order, every rank captures the same CUDA graphs, with their
  all-reduces inside.

The messages ride a gloo group of their own (the *control* group, on the
host); the forward's collectives ride the *data* group, the default
process group: NCCL with one card per rank (the default), or gloo on the
CPU, or gloo for ranks that share one card (its collectives then copy
through host tensors: :attr:`TPGroup.path` is ``'gloo-host-copy'``;
NCCL never takes that path). Nothing picks a backend by itself: the
caller passes one or takes the default of its device.

Workers either start here (:func:`local_group`: ``tp - 1`` fresh
interpreters, never a fork of this threaded process) or are the other
processes of a gang (:func:`gang_group`, after
``parallel/distributed.maybe_initialize``). A worker serves one engine
after another (``build`` replaces the last one), so one group can carry
many engines, each sent its slices when it is built. A worker whose
operation raises exits, and so does a worker whose rank 0 is gone;
rank 0 sees a dead worker at its next message or collective as an
exception (gloo reports the closed connection at once; a silent peer
raises after ``distributed.TP_TIMEOUT``), which the engine's supervisor
turns into a permanent failure.

Run a worker by hand: ``python -m skypilot_tpu_torch.parallel.tp --rank
1 --size 2 --init-method tcp://127.0.0.1:PORT --backend gloo --devices
cpu,cpu`` (what :func:`local_group` starts).
"""
import argparse
import datetime
import gc
import logging
import os
import subprocess
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)

_REDUCE_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}
# A worker waits this long for its next message (an idle replica is not
# a dead one); rank 0's waits are bounded by the group's timeout.
_WORKER_WAIT = datetime.timedelta(days=3650)


class TPWorkerDied(RuntimeError):
    """A worker process of the group is gone."""


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class TPGroup:
    """One rank's view of a tensor-parallel group: its rank and device,
    the data group's collectives and the control group's messages.

    The collectives must be called by every rank in the same order (the
    forward does); the messages go from rank 0 to the workers and the
    replies back."""

    def __init__(self, rank: int, devices: Sequence[torch.device],
                 backend: str, ctrl, procs: Optional[list] = None):
        self.rank = rank
        self.size = len(devices)
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[rank]
        self.backend = backend
        self._ctrl = ctrl
        self._procs = list(procs or [])
        # Messages and their replies are one exchange: one at a time.
        self.lock = threading.RLock()
        self.closed = False
        # The engine the workers hold now (rank 0): a message from any
        # other engine raises.
        self.owner: Any = None

    @property
    def path(self) -> str:
        """How the data group's collectives move bytes: 'nccl', 'gloo'
        (CPU ranks) or 'gloo-host-copy' (CUDA ranks over gloo: each
        collective copies to host tensors and back)."""
        if self.backend == 'gloo' and self.device.type == 'cuda':
            return 'gloo-host-copy'
        return self.backend

    # ----------------------------------------------------- collectives

    def _host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == 'gloo'

    def all_reduce(self, t: torch.Tensor, op: str = 'sum') -> torch.Tensor:
        """``t`` reduced over the ranks (``op`` 'sum' or 'max'); in place
        when ``t`` is contiguous and no host copy is needed."""
        if self._host(t):
            h = t.cpu()
            dist.all_reduce(h, op=_REDUCE_OPS[op])
            return h.to(t.device)
        t = t.contiguous()
        dist.all_reduce(t, op=_REDUCE_OPS[op])
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, rank order."""
        src = t.contiguous()
        host = self._host(src)
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if host else out

    # -------------------------------------------------------- messages

    def check_alive(self) -> None:
        """Raise :class:`TPWorkerDied` when a local worker has exited."""
        if self.closed:
            raise TPWorkerDied('the TP group is closed')
        for r, p in enumerate(self._procs, start=1):
            code = p.poll()
            if code is not None:
                raise TPWorkerDied(f'TP worker rank {r} exited with code '
                                   f'{code}')

    def alive(self) -> bool:
        try:
            self.check_alive()
        except TPWorkerDied:
            return False
        return True

    def post(self, op: str, args: Optional[dict] = None,
             tensors: Optional[Dict[int, Any]] = None) -> None:
        """Rank 0: send ``op`` with its picklable ``args`` to every
        worker, and each worker ``r`` the tensors ``tensors[r]`` (a list,
        or a callable that makes it, so the host holds one worker's
        tensors at a time)."""
        tensors = tensors or {}
        with self.lock:
            self.check_alive()
            dist.broadcast_object_list(
                [{'op': op, 'args': args or {}, 'ranks': sorted(tensors)}],
                src=0, group=self._ctrl)
            for r in sorted(tensors):
                ts = tensors[r]() if callable(tensors[r]) else tensors[r]
                dist.send_object_list(
                    [[(tuple(t.shape), t.dtype) for t in ts]], dst=r,
                    group=self._ctrl)
                for t in ts:
                    if t.numel():
                        dist.send(_as_bytes(t.cpu()), dst=r,
                                  group=self._ctrl)
                del ts

    def receive(self):
        """A worker: the next (op, args, tensors) from rank 0."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._ctrl)
        header = box[0]
        out = []
        if self.rank in header['ranks']:
            specs = [None]
            dist.recv_object_list(specs, src=0, group=self._ctrl)
            for shape, dtype in specs[0]:
                t = torch.empty(shape, dtype=dtype)
                if t.numel():
                    buf = torch.empty(t.numel() * t.element_size(),
                                      dtype=torch.uint8)
                    dist.recv(buf, src=0, group=self._ctrl)
                    t = buf.view(dtype).reshape(shape)
                out.append(t)
        return header['op'], header['args'], out

    def reply_tensors(self, tensors: Sequence[torch.Tensor]) -> None:
        """A worker: send its result tensors to rank 0."""
        for t in tensors:
            if t.numel():
                dist.send(_as_bytes(t.cpu()), dst=0, group=self._ctrl)

    def collect_tensors(self, like: Sequence[torch.Tensor]
                        ) -> List[List[torch.Tensor]]:
        """Rank 0: each worker's reply, shaped as ``like`` (rank 0's own
        result), in rank order from rank 1."""
        out = []
        with self.lock:
            for r in range(1, self.size):
                got = []
                for t in like:
                    buf = torch.empty(t.numel() * t.element_size(),
                                      dtype=torch.uint8)
                    if t.numel():
                        dist.recv(buf, src=r, group=self._ctrl)
                    got.append(buf.view(t.dtype).reshape(t.shape))
                out.append(got)
        return out

    def reply_object(self, obj) -> None:
        dist.gather_object(obj, None, dst=0, group=self._ctrl)

    def collect_objects(self, own) -> list:
        """Rank 0: every rank's reply object, rank 0's (``own``) first."""
        out = [None] * self.size
        with self.lock:
            dist.gather_object(own, out, dst=0, group=self._ctrl)
        return out

    def close(self) -> None:
        """Rank 0: end the workers' loops, reap the local ones and leave
        the process group. Idempotent."""
        if self.closed:
            return
        try:
            if self.rank == 0 and self.alive():
                self.post('exit')
        except Exception:  # pylint: disable=broad-except
            pass
        self.closed = True
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()


def _join(rank: int, devices, backend: str, init_method: str,
          ctrl_timeout: datetime.timedelta) -> Any:
    """Form the data group (the default process group) and the control
    group; returns the control group."""
    if backend == 'nccl':
        torch.cuda.set_device(devices[rank])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=len(devices), rank=rank,
                            timeout=distributed.TP_TIMEOUT)
    return dist.new_group(backend='gloo', timeout=ctrl_timeout)


def local_group(tp: int, devices: Optional[Sequence] = None,
                backend: Optional[str] = None,
                platform: str = 'cuda') -> TPGroup:
    """A ``tp``-way group on this host: this process is rank 0, and
    ``tp - 1`` worker processes start here. ``devices`` (one a rank)
    default to the visible cards, or to CPU ranks with ``platform``
    'cpu'; ``backend`` defaults to NCCL on cards and gloo on the CPU.
    Two ranks on one card need ``backend='gloo'`` (NCCL refuses a
    repeated card)."""
    devices = mesh.serving_devices(tp, devices, platform)
    if backend is None:
        backend = 'nccl' if devices[0].type == 'cuda' else 'gloo'
    mesh.check_backend(backend, devices)
    if dist.is_initialized():
        raise RuntimeError('this process already has a process group: '
                           'close the open TP group first')
    init_method = f'tcp://127.0.0.1:{distributed.free_port()}'
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (distributed.PACKAGE_ROOT, env.get('PYTHONPATH')) if p)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.parallel.tp',
           '--size', str(tp), '--init-method', init_method,
           '--backend', backend,
           '--devices', ','.join(str(d) for d in devices),
           '--threads', str(torch.get_num_threads())]
    procs = [subprocess.Popen(cmd + ['--rank', str(r)], env=env)
             for r in range(1, tp)]
    try:
        ctrl = _join(0, devices, backend, init_method, distributed.TP_TIMEOUT)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return TPGroup(0, devices, backend, ctrl, procs)


def gang_group(tp: int, platform: str = 'cuda') -> TPGroup:
    """Rank 0's group over the gang's default process group (formed by
    ``distributed.maybe_initialize``): every process of the gang is a
    rank, on a card of its host (``platform`` 'cuda') or the CPU."""
    world = dist.get_world_size()
    if tp != world:
        raise ValueError(f'tp={tp} must equal the gang\'s {world} '
                         'processes (one rank each)')
    return TPGroup(dist.get_rank(), _gang_devices(world, platform),
                   dist.get_backend(),
                   dist.new_group(backend='gloo',
                                  timeout=distributed.TP_TIMEOUT))


def _gang_devices(world: int, platform: str) -> List[torch.device]:
    if platform == 'cpu':
        return [torch.device('cpu')] * world
    n = torch.cuda.device_count()
    return [torch.device(f'cuda:{r % n}') for r in range(world)]


def serve_gang(platform: str = 'cuda') -> None:
    """A gang process other than 0: join the control group as rank 0's
    :func:`gang_group` makes it, then serve until rank 0 is gone."""
    world = dist.get_world_size()
    ctrl = dist.new_group(backend='gloo', timeout=_WORKER_WAIT)
    devices = _gang_devices(world, platform)
    if platform == 'cuda':
        torch.cuda.set_device(devices[dist.get_rank()])
    serve(TPGroup(dist.get_rank(), devices, dist.get_backend(), ctrl))


def serve(group: TPGroup) -> None:
    """The worker loop: run rank 0's operations on this rank's shard
    until ``exit`` or until rank 0 is gone. An operation that raises
    ends the process (rank 0 then sees the closed connection)."""
    from skypilot_tpu_torch.models import engine as engine_lib  # pylint: disable=import-outside-toplevel
    shard = None
    while True:
        try:
            op, args, tensors = group.receive()
        except Exception:  # pylint: disable=broad-except
            logger.info('TP worker rank %d: rank 0 is gone', group.rank)
            break
        if op == 'exit':
            break
        try:
            if op == 'build':
                shard = None
                gc.collect()
                shard = engine_lib.EngineShard.from_message(group, args,
                                                            tensors)
            elif op == 'close':
                shard = None
                gc.collect()
                if group.device.type == 'cuda':
                    torch.cuda.empty_cache()
            else:
                shard.serve_op(op, args, tensors)
        except Exception:  # pylint: disable=broad-except
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)  # pylint: disable=protected-access
    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description='One worker rank of a tensor-parallel replica.')
    parser.add_argument('--rank', type=int, required=True)
    parser.add_argument('--size', type=int, required=True)
    parser.add_argument('--init-method', required=True)
    parser.add_argument('--backend', choices=mesh.BACKENDS, required=True)
    parser.add_argument('--devices', required=True,
                        help='one device a rank, comma-separated')
    parser.add_argument('--threads', type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.threads:
        torch.set_num_threads(args.threads)
    devices = [torch.device(d) for d in args.devices.split(',')]
    if len(devices) != args.size:
        parser.error('--devices needs one device a rank')
    ctrl = _join(args.rank, devices, args.backend, args.init_method,
                 _WORKER_WAIT)
    serve(TPGroup(args.rank, devices, args.backend, ctrl))


if __name__ == '__main__':
    main()
