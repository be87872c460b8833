"""``torch.distributed`` bootstrap from the gang-runtime environment.

Counterpart of ``skypilot_tpu/parallel/distributed.py``. The gang runtime
injects the multi-host rendezvous triple into every rank's task
environment: ``JAX_COORDINATOR_ADDRESS`` (head host + fixed port),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` (the names are the gang's,
kept as they are). The reference turns them into one
``jax.distributed.initialize``; here they form the default process group,
``torch.distributed.init_process_group(init_method='tcp://<address>',
world_size, rank)``, which a tensor-parallel replica
(``parallel/tp.gang_group``) then spans.

Under a gang every process is a rank on ``cuda:(rank % cards)``
(:func:`join_gang`). The trainers run as a JAX gang does: one SPMD
program, every rank the same train step on its own slices
(``models/train.main``, ``models/resnet.main``). A serving replica
differs in idiom: process 0 serves HTTP and owns the scheduler, and
every other process runs the TP worker loop (``parallel/tp.serve``)
replaying process 0's device dispatches.

:func:`local_ranks` runs one function SPMD on ranks of this host, this
process and fresh interpreters (the tests and ``chip_smoke.py``).

Call :func:`maybe_initialize` before the first device access.
Idempotent and safe everywhere: no coordinator env or a one-process gang
is a no-op. ``SKYTPU_DISABLE_JAX_DISTRIBUTED=1`` opts out (several
independent replicas on the hosts of one gang).
"""
import argparse
import datetime
import importlib
import logging
import os
import socket
import subprocess
import sys
import tempfile
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)

COORDINATOR_ENV = 'JAX_COORDINATOR_ADDRESS'
NUM_PROCESSES_ENV = 'JAX_NUM_PROCESSES'
PROCESS_ID_ENV = 'JAX_PROCESS_ID'
DISABLE_ENV = 'SKYTPU_DISABLE_JAX_DISTRIBUTED'
# How long a collective or a rendezvous may wait on a peer before it
# raises (a dead rank fails the engine instead of hanging it).
TP_TIMEOUT = datetime.timedelta(seconds=300)

# The directory holding the package: a local rank's PYTHONPATH.
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_initialized = False


def distributed_env() -> Optional[dict]:
    """The gang-injected rendezvous triple, or None when this process is
    not part of a multi-process gang (no coordinator env, or a
    single-process gang: nothing to rendezvous)."""
    coordinator = os.environ.get(COORDINATOR_ENV)
    if not coordinator:
        return None
    try:
        num_processes = int(os.environ.get(NUM_PROCESSES_ENV, '1'))
        process_id = int(os.environ.get(PROCESS_ID_ENV, '0'))
    except ValueError:
        logger.warning('Malformed %s/%s; skipping torch.distributed init.',
                       NUM_PROCESSES_ENV, PROCESS_ID_ENV)
        return None
    if num_processes <= 1:
        return None
    return {
        'coordinator_address': coordinator,
        'num_processes': num_processes,
        'process_id': process_id,
    }


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """The default process group from the gang env, once. Returns True
    when a multi-process group was (or already is) formed. ``backend``
    defaults to NCCL when the process sees a card (one card per rank)
    and to gloo on the CPU."""
    global _initialized
    if _initialized:
        return True
    if os.environ.get(DISABLE_ENV, '').lower() in ('1', 'true'):
        return False
    env = distributed_env()
    if env is None:
        return False
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    logger.info('torch.distributed: process %d/%d via %s (%s)',
                env['process_id'], env['num_processes'],
                env['coordinator_address'], backend)
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f'tcp://{env["coordinator_address"]}',
        world_size=env['num_processes'], rank=env['process_id'],
        timeout=TP_TIMEOUT)
    _initialized = True
    return True


def process_index() -> int:
    """This process's rank in the gang (0 outside one)."""
    if _initialized and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def join_gang(device: torch.device) -> torch.device:
    """This process's device under the gang env, the group formed: a
    CUDA run takes ``cuda:(rank % cards)`` (one card a rank where the
    host has one a rank) over NCCL, a CPU run gloo. Outside a gang,
    ``device`` as given."""
    env = distributed_env()
    if env is None or os.environ.get(DISABLE_ENV, '').lower() in (
            '1', 'true'):
        return device
    if device.type == 'cuda':
        device = torch.device(
            f'cuda:{env["process_id"] % torch.cuda.device_count()}')
        torch.cuda.set_device(device)
    maybe_initialize('nccl' if device.type == 'cuda' else 'gloo')
    return device


def check_agree(settings: dict) -> None:
    """Raise on every rank unless every rank of the default process
    group passes equal ``settings`` (a gang that would otherwise build
    different meshes fails before its first collective of work instead
    of hanging in it)."""
    if not dist.is_initialized():
        return
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, settings)
    if any(s != seen[0] for s in seen):
        raise ValueError('the processes of the gang disagree: ' + '; '.join(
            f'process {r}: {s}' for r, s in enumerate(seen)))


# ------------------------------------------------- ranks on this host


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _join(rank: int, devices: Sequence[torch.device], backend: str,
          init_method: str) -> None:
    if devices[rank].type == 'cuda':
        torch.cuda.set_device(devices[rank])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=len(devices), rank=rank,
                            timeout=TP_TIMEOUT)


def _resolve(call: Tuple[str, str, str]) -> Callable:
    """The function a rank runs, by module name, file and qualname (a
    script's functions by their file)."""
    name, path, qualname = call
    if path:
        sys.path.insert(0, os.path.dirname(path))
        if name == '__main__':
            name = os.path.splitext(os.path.basename(path))[0]
    obj: Any = importlib.import_module(name)
    for part in qualname.split('.'):
        obj = getattr(obj, part)
    return obj


def local_ranks(n: int, fn: Callable, args: Sequence = (),
                devices: Optional[Sequence] = None,
                backend: Optional[str] = None,
                platform: str = 'cuda') -> Any:
    """Run ``fn(*args)`` on ``n`` ranks of this host, SPMD: this process
    is rank 0 and ``n - 1`` fresh interpreters (never forks of this
    process) are the others. Each rank first joins a default process
    group over ``devices`` (one a rank; default the visible cards, or
    CPU ranks with ``platform`` 'cpu') with ``backend`` (default NCCL on
    cards, gloo on the CPU; ranks sharing one card need 'gloo'), and
    leaves it after. The ranks split this process's intra-op threads
    (they share the host's cores; CPU ranks run one thread each, so
    tests under xdist do not oversubscribe it). ``fn`` must be a
    module-level function and ``args`` picklable.

    Returns rank 0's result. A rank that raises fails the call: its
    peers see the closed connection at their next collective, and this
    process raises after reaping every rank."""
    devices = mesh.serving_devices(n, devices, platform)
    if backend is None:
        backend = 'nccl' if devices[0].type == 'cuda' else 'gloo'
    mesh.check_backend(backend, devices)
    if dist.is_initialized():
        raise RuntimeError('this process already has a process group')
    module = sys.modules[fn.__module__]
    call = (fn.__module__, getattr(module, '__file__', None) or '',
            fn.__qualname__)
    fd, path = tempfile.mkstemp(prefix='skytpu_ranks_', suffix='.pt')
    with os.fdopen(fd, 'wb') as f:
        torch.save((call, tuple(args)), f)
    init_method = f'tcp://127.0.0.1:{free_port()}'
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get('PYTHONPATH')) if p)
    threads = torch.get_num_threads()
    per_rank = 1 if devices[0].type == 'cpu' else max(1, threads // n)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.parallel.distributed',
           '--size', str(n), '--init-method', init_method,
           '--backend', backend, '--devices', ','.join(map(str, devices)),
           '--call', path,
           '--threads', str(per_rank)]
    procs = [subprocess.Popen(cmd + ['--rank', str(r)], env=env)
             for r in range(1, n)]
    try:
        torch.set_num_threads(per_rank)
        _join(0, devices, backend, init_method)
        result = fn(*args)
        dist.destroy_process_group()
        codes = [p.wait(timeout=TP_TIMEOUT.total_seconds()) for p in procs]
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    finally:
        torch.set_num_threads(threads)
        os.unlink(path)
    failed = {r: c for r, c in enumerate(codes, start=1) if c}
    if failed:
        raise RuntimeError(f'ranks exited with codes {failed}')
    return result


def _rank_main(argv=None) -> None:
    """One rank of :func:`local_ranks` (what it starts)."""
    parser = argparse.ArgumentParser(
        description='One rank of a local SPMD run.')
    parser.add_argument('--rank', type=int, required=True)
    parser.add_argument('--size', type=int, required=True)
    parser.add_argument('--init-method', required=True)
    parser.add_argument('--backend', required=True)
    parser.add_argument('--devices', required=True)
    parser.add_argument('--call', required=True)
    parser.add_argument('--threads', type=int, required=True)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    devices = [torch.device(d) for d in args.devices.split(',')]
    try:
        _join(args.rank, devices, args.backend, args.init_method)
        call, call_args = torch.load(args.call, weights_only=False)
        _resolve(call)(*call_args)
        dist.destroy_process_group()
    except BaseException:  # pylint: disable=broad-except
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # pylint: disable=protected-access


if __name__ == '__main__':
    _rank_main()
