"""What every cell shares: finding a cell's files by name, the run's
environment, the device's description, the reduction of a profiler
trace, the metric readers, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is found by
name: its configuration file is the one ``BENCHMARK.json`` names, its
traffic mix ``portbench/traffic/<traffic>.json``, its own settings
(kind, rate, limits) ``portbench/workloads/<cell>.json``, the code that
runs it ``portbench/kinds/<kind>.py``, and each metric it reports
``portbench/metrics/<metric>.py`` (:func:`metric_file`). A later cell, mix or metric is a new
file, and no file here changes.
"""
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
PB = ROOT / 'portbench'
# Build and kernel caches of the program, at fixed paths inside the
# checkout, so that only a checkout's first run builds.
CACHE_DIR = ROOT / 'build' / 'portbench'
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'skypilot_tpu')


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    kind: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get('workloads', [cell])


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    entry = next((w for w in bench['workloads'] if w['name'] == name),
                 None)
    if entry is None:
        raise SystemExit(f'no workload named {name!r} in BENCHMARK.json')
    config = next(c for c in bench['configs']
                  if c['name'] == entry['config'])
    spec = json.loads((PB / 'workloads' / f'{name}.json').read_text())
    e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (name in m['workloads'] if 'workloads' in m
                     else m['moves'] in e2e_names)]
    return Cell(
        name=name, chips=entry['chips'], kind=spec['kind'],
        config=json.loads((ROOT / config['file']).read_text()),
        traffic=json.loads((PB / 'traffic' /
                            f"{entry['traffic']}.json").read_text()),
        spec=spec, end_to_end=e2e, per_layer=per_layer)


def prepare_environment() -> None:
    """Caches inside the checkout; the program's journal beside them;
    no library loads JAX behind the port's back."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ['TRITON_CACHE_DIR'] = str(CACHE_DIR / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE_DIR / 'torch_extensions')
    os.environ['SKYTPU_JOURNAL_PATH'] = str(CACHE_DIR / 'journal.db')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def stage(name: str, t_start: float) -> None:
    """Print on standard error how far into the run set-up has come."""
    print(f'set-up: {name} at {time.monotonic() - t_start:.2f} s',
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def kind_module(kind: str):
    return importlib.import_module(f'portbench.kinds.{kind}')


def metric_file(name: str) -> Path:
    """A metric's reader: ``metrics/<name>.py``, or, for one quantity
    split by the end-to-end metric it moves (``device.idle_share.serve``
    and ``.train``), the quantity's own file without the last part of
    the name (``metrics/device.idle_share.py``)."""
    path = PB / 'metrics' / f'{name}.py'
    if not path.exists() and '.' in name:
        path = PB / 'metrics' / f'{name.rsplit(".", 1)[0]}.py'
    return path


def metric_reader(name: str) -> Callable:
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def device_info(torch, context) -> Dict[str, Any]:
    """The result line's ``device``: the one card a run used (the CPU in
    a dry run), the window's peak memory and, traced, the device's busy
    seconds and the traced window's length."""
    if torch.cuda.is_available():
        dev = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
               'count': 1}
    else:
        dev = {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    dev['memory_peak_bytes'] = context.peak_bytes
    if context.trace is not None:
        dev['busy_s'] = context.trace.busy_s
        dev['window_s'] = context.trace.window_s
    return dev


# ---------------------------------------------------------------- trace

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
# A host span around the traced seconds, opened after the profiler
# starts and closed before it stops: the trace is read over it alone.
WINDOW_MARK = 'portbench.traced_window'
HOST_CATEGORIES = ('cpu_op', 'cuda_runtime', 'user_annotation',
                   'cuda_driver')


@dataclasses.dataclass
class Trace:
    """A profiled window reduced to what the readers use: device
    operations ``(name, start_us, end_us)`` sorted by start, the
    seconds some operation ran, the window's length, and the breakdown
    the result line carries."""
    ops: List[tuple]
    busy_s: float
    window_s: float
    breakdown: Dict[str, list]

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e6


def _union_seconds(intervals) -> float:
    total, end = 0.0, -math.inf
    for s, e in intervals:
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def reduce_trace(path: Path) -> Trace:
    """Read a chrome trace the profiler exported, over the traced window
    that :data:`WINDOW_MARK` spans in it: the device operations clipped
    to it, the union of their intervals (busy), the ten operations that
    took most time, and the ten longest gaps with no device operation,
    each named by the innermost host operation running at its middle."""
    events = json.loads(Path(path).read_text()).get('traceEvents', [])
    spans = [ev for ev in events if ev.get('ph') == 'X' and 'dur' in ev]
    mark = [ev for ev in spans if ev['name'] == WINDOW_MARK]
    if not mark:
        raise RuntimeError(f'the trace holds no {WINDOW_MARK!r} span')
    w0 = float(mark[0]['ts'])
    w1 = w0 + float(mark[0]['dur'])
    ops, host = [], []
    for ev in spans:
        cat = ev.get('cat', '')
        s = float(ev['ts'])
        e = s + float(ev['dur'])
        if cat in DEVICE_CATEGORIES:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                ops.append((ev['name'], s, e))
        elif cat in HOST_CATEGORIES and ev['name'] != WINDOW_MARK:
            host.append((ev['name'], s, e))
    ops.sort(key=lambda x: x[1])
    busy = _union_seconds((s, e) for _, s, e in ops)
    by_name: Dict[str, float] = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, cursor = [], w0
    for _, s, e in ops:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) / 2
        inner = [h for h in host if h[1] <= mid <= h[2]]
        label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                 else 'no host operation traced')
        named.append([f'host: {label}', (e - s) / 1e6])
    return Trace(ops=ops, busy_s=busy, window_s=(w1 - w0) / 1e6,
                 breakdown={'device_ops': [[n, v] for n, v in top],
                            'idle_gaps': named})


def export_and_reduce(prof, path: Path) -> Trace:
    """Export a stopped profiler's trace to ``path``, reduce it and
    delete the file."""
    t0 = time.monotonic()
    prof.export_chrome_trace(str(path))
    t1 = time.monotonic()
    trace = reduce_trace(path)
    print(f'trace: {len(trace.ops)} device operations over '
          f'{trace.window_s:.3f} s, exported in {t1 - t0:.1f} s, read in '
          f'{time.monotonic() - t1:.1f} s', file=sys.stderr, flush=True)
    path.unlink()
    return trace


def profiler(torch):
    """A profiler of the host's operations and the card's."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def warm_profiler(torch) -> None:
    """Start and stop a profiler once in set-up: its first start
    initialises the device tracer, which takes seconds."""
    prof = profiler(torch)
    prof.start()
    torch.zeros(1, device='cuda').add_(1)
    torch.cuda.synchronize()
    prof.stop()


# --------------------------------------------------------------- result


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back: the numbers compared with their
    limits (``checks``: name → (value, limit); the run is correct when
    every value is at most its limit and nothing failed), the requests
    or steps attempted and failed, the device's description and the
    context the metric readers read."""
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    device: Dict[str, Any]
    context: Any
    complete: bool = True

    @property
    def correct(self) -> bool:
        return (self.complete and self.failed == 0 and
                all(v <= lim for v, lim in self.checks.values()))


def metrics_of(cell: Cell, trace: bool, context) -> Dict[str, Dict]:
    chosen = cell.per_layer if trace else cell.end_to_end
    out = {}
    for m in chosen:
        value = metric_reader(m['name'])(context)
        if value is None:
            continue
        if not math.isfinite(value):
            # A tail over failed requests; the run is not correct.
            print(f'{m["name"]} = {value!r}: left out of the line',
                  file=sys.stderr)
            continue
        out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def result_line(cell: Cell, trace: bool, outcome: Outcome) -> Dict:
    line = {'correct': outcome.correct, 'attempted': outcome.attempted,
            'failed': outcome.failed,
            'metrics': metrics_of(cell, trace, outcome.context),
            'device': outcome.device}
    if trace and outcome.context.trace is not None:
        line['breakdown'] = outcome.context.trace.breakdown
    line['checks'] = {name: {'value': v, 'limit': lim}
                      for name, (v, lim) in outcome.checks.items()}
    return line


def report_checks(outcome: Outcome) -> None:
    """The numbers compared, each beside its limit, as the last lines
    on standard error."""
    for name, (v, lim) in outcome.checks.items():
        verdict = 'ok' if v <= lim else 'FAILS'
        print(f'check {name} = {v!r} limit {lim!r} {verdict}',
              file=sys.stderr, flush=True)
    print(f'check failed_requests_or_steps = {outcome.failed} limit 0 '
          f'{"ok" if outcome.failed == 0 else "FAILS"}', file=sys.stderr,
          flush=True)
