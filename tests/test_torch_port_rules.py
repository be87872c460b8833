"""Rules of the PyTorch/CUDA port: ``skypilot_tpu_torch/`` and
``chip_smoke.py`` import neither ``jax`` nor anything of the JAX package
``skypilot_tpu``, importing the port pulls no JAX into the process, and
its entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from skypilot_tpu_torch.models import checkpoint, llama, train
from skypilot_tpu_torch.serve import model_server

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO_ROOT, 'skypilot_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'skypilot_tpu', 'ml_dtypes')


def _port_files():
    files = [os.path.join(REPO_ROOT, 'chip_smoke.py')]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _imported_modules(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) >= 10, files
    bad = [(os.path.relpath(path, REPO_ROOT), mod)
           for path in files for mod in _imported_modules(path)
           if mod.split('.')[0] in FORBIDDEN]
    assert bad == [], bad


def test_importing_the_port_leaves_jax_out_of_the_process():
    code = ('import sys\n'
            'import chip_smoke\n'
            'from skypilot_tpu_torch.serve import model_server\n'
            'from skypilot_tpu_torch.models import checkpoint, convert, data\n'
            'from skypilot_tpu_torch.models import decode, engine, train\n'
            'from skypilot_tpu_torch.models import prefix_transfer\n'
            'from skypilot_tpu_torch.ops import cuda_build, flash_attention\n'
            'from skypilot_tpu_torch.observability import journal, metrics\n'
            'from skypilot_tpu_torch.observability import request_trace\n'
            'from skypilot_tpu_torch.observability import runtime_metrics\n'
            'from skypilot_tpu_torch.observability import trace\n'
            'from skypilot_tpu_torch.utils import chaos, db_utils, env\n'
            'bad = sorted(m for m in sys.modules\n'
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'skypilot_tpu'))\n"
            'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        assert model_server.resolve_device().type == 'cuda'
        return
    cfg, tc = llama.CONFIGS['debug'], train.TrainConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_server.build_engine('debug', 1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(cfg, tc, 1, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.init_train_state(cfg, tc)
    state = train.init_train_state(cfg, tc, 'cpu')
    checkpoint.save(str(tmp_path), state, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.restore_latest(str(tmp_path))
    assert checkpoint.restore_latest(str(tmp_path), 'cpu')[1] == 1
    with pytest.raises(RuntimeError, match='CUDA'):
        model_server.resolve_device('cuda')
    assert model_server.resolve_device('cpu').type == 'cpu'


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card: exit non-zero and print no result line; alone in a
    directory: the same."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    for cwd in (REPO_ROOT, tmp_path):
        script = os.path.join(REPO_ROOT, 'chip_smoke.py')
        if cwd == tmp_path:
            script = str(tmp_path / 'chip_smoke.py')
            with open(os.path.join(REPO_ROOT, 'chip_smoke.py'),
                      encoding='utf-8') as src, open(script, 'w',
                                                     encoding='utf-8') as dst:
                dst.write(src.read())
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
