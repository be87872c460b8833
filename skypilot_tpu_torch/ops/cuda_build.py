"""Build the hand-written CUDA kernels and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). The library name carries a digest of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. ``build()`` starts one ``nvcc`` per source, all at once, and
waits for them together.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
# name → source file under csrc/.
SOURCES = {'decode_attention': 'decode_attention.cu',
           'flash_attention': 'flash_attention.cu',
           'flash_forward_wgmma': 'flash_forward_wgmma.cu',
           'flash_backward_wgmma': 'flash_backward_wgmma.cu'}
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found (PATH or $CUDA_HOME/bin): the CUDA '
                       'kernels are built on a machine with the CUDA '
                       'toolkit')


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns seconds per library built (0.0
    for one already present). The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``.
    Raises RuntimeError with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix('.log').write_bytes(log)
        if proc.returncode != 0:
            failures.append(f'{name}: nvcc exited {proc.returncode}\n'
                            f'{log.decode(errors="replace")}')
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError('CUDA kernel build failed:\n' +
                           '\n'.join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
