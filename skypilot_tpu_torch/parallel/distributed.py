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

The process roles differ from the reference's in idiom: a JAX gang runs
one SPMD program on every process, while here process 0 serves HTTP and
owns the scheduler, and every other process runs the TP worker loop
(``parallel/tp.serve``) replaying process 0's device dispatches.

Call :func:`maybe_initialize` before the first device access.
Idempotent and safe everywhere: no coordinator env or a one-process gang
is a no-op. ``SKYTPU_DISABLE_JAX_DISTRIBUTED=1`` opts out (several
independent replicas on the hosts of one gang).
"""
import datetime
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

COORDINATOR_ENV = 'JAX_COORDINATOR_ADDRESS'
NUM_PROCESSES_ENV = 'JAX_NUM_PROCESSES'
PROCESS_ID_ENV = 'JAX_PROCESS_ID'
DISABLE_ENV = 'SKYTPU_DISABLE_JAX_DISTRIBUTED'
# How long a collective or a rendezvous may wait on a peer before it
# raises (a dead rank fails the engine instead of hanging it).
TP_TIMEOUT = datetime.timedelta(seconds=300)

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
