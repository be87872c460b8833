"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared beside its limit, which also close
standard error. Exits non-zero, printing no result, without as many
CUDA cards as the cell asks for, or when JAX or the JAX package was
loaded by the time the window closed.
"""
import time

T_START = time.monotonic()

# pylint: disable=wrong-import-position
import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: the benchmark measures the card',
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 2
    outcome = harness.kind_module(cell.kind).run(
        cell, args.seed, args.seconds, bool(args.trace), 'cuda', T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f'JAX or the JAX package was loaded: {loaded}',
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, bool(args.trace), outcome)
    harness.report_checks(outcome)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
