"""``BENCHMARK.json`` against the benchmark's contract, and every cell it
names resolving to its files: a configuration, a traffic mix read by a
generator, a workload file with its kind and limits, and a reader for
each metric the cell reports."""
import json
import re
import statistics
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
    assert BENCH['paths'] == ['portbench']
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = [c['name'] for c in BENCH['configs']] + CELLS + [
        m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert all(NAME.match(n) for n in names)
    assert len(set(c['name'] for c in BENCH['configs'])) == len(
        BENCH['configs'])
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m['name'] for m in BENCH['end_to_end'] +
                    BENCH['per_layer']]
    assert len(set(metric_names)) == len(metric_names)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/')
        assert all(NAME.match(k) for k in c['reduced'])
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in BENCH['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    assert any(m['name'] == 'setup_s' and m['bound'] == 0.25
               for m in BENCH['end_to_end'])


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    entry = next(w for w in BENCH['workloads'] if w['name'] == name)
    assert entry['chips'] in (1, 4) and len(entry['why']) <= 200
    kind = harness.kind_module(cell.kind)
    assert callable(kind.run)
    generator = cell.traffic['generator']
    assert (ROOT / 'portbench' / 'generators' / f'{generator}.py').exists()
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m['name']))
    for m in cell.per_layer:
        assert m['moves'] in e2e
    assert cell.spec['limits']


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH['per_layer']:
        for cell in m['workloads']:
            e2e = {x['name'] for x in harness.load_cell(cell).end_to_end}
            assert m['moves'] in e2e, (m['name'], cell)


def test_layers_are_named_alike():
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert all(0 < len(layer) <= 200 and '\n' not in layer
               for layer in layers)


def test_configs_state_their_cuts():
    for c in BENCH['configs']:
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['source'] == c['source']
        assert sorted(cfg['reduced']) == sorted(c['reduced'])
        widths = ('hidden_size', 'intermediate_size', 'num_attention_heads',
                  'num_key_value_heads', 'num_experts_per_tok')
        assert not set(c['reduced']) & set(widths)


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = [w for w in BENCH['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(BENCH['workloads']) // 4)


def test_limits_sit_between_their_readings():
    """Each limit lies above the highest sound reading and below the
    lowest reading that must fail, as the workload files record them."""
    for name in CELLS:
        spec = harness.load_cell(name).spec
        for key, limit in spec['limits'].items():
            read = spec['readings'][key]
            assert max(read['sound']) < limit < read['upper'], key
            assert statistics.median(read['sound']) < limit


def test_metric_readers_exist_only_for_named_metrics():
    named = {m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']}
    used = {harness.metric_file(n) for n in named}
    files = set((ROOT / 'portbench' / 'metrics').glob('*.py'))
    assert all(p.exists() for p in used)
    assert used == files
    # One quantity split by what it moves is read by one file.
    assert harness.metric_file('device.idle_share.serve') == \
        harness.metric_file('device.idle_share.train')
