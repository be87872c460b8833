"""Nothing under ``portbench/`` imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole, so the port, whose name begins
with the JAX package's, passes), nothing reads the JAX package's benches,
the reference imports nothing of the port, and after a dry run of both
cells on the CPU neither JAX nor the JAX package is in ``sys.modules``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'skypilot_tpu'}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.', 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.', 1)[0]


def sources():
    return sorted(p for p in PB.rglob('*.py') if '__pycache__' not in
                  p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_top_level_names_are_compared_whole():
    assert 'skypilot_tpu_torch' not in FORBIDDEN
    assert harness.FORBIDDEN_MODULES == ('jax', 'jaxlib', 'flax',
                                         'skypilot_tpu')


def test_nothing_reads_the_jax_packages_benches():
    benches = ['/'.join(('skypilot_tpu', 'benchmark')),
               '.'.join(('skypilot_tpu', 'benchmark'))]
    for path in sources():
        text = path.read_text()
        assert not any(b in text for b in benches), path


def test_reference_imports_nothing_of_the_program():
    for name in ('reference.py', 'weights.py', 'peaks.py'):
        tops = set(imported_tops(PB / name))
        assert not tops & {'skypilot_tpu_torch', 'skypilot_tpu'}, name


DRY_RUN = '''
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from portbench import harness
from portbench.kinds import serve, train
from portbench_tiny import tiny_serve_cell, tiny_train_cell
for kind, cell in ((serve, tiny_serve_cell()), (train, tiny_train_cell())):
    out = kind.run(cell, 3, 1.0, False, 'cpu', time.monotonic())
    assert out.attempted > 0
print(json.dumps(harness.forbidden_modules()))
'''


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    code = DRY_RUN.format(root=str(PB.parent), tests=str(PB / 'tests'))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
