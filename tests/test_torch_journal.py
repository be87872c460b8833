"""The port's journal (skypilot_tpu_torch/observability/journal.py) and its
sqlite helper (skypilot_tpu_torch/utils/db_utils.py) against the
reference's (skypilot_tpu/observability/journal.py).

* The two ``EventKind`` vocabularies have equal values, and the two
  schemas create equal ``sqlite_master`` SQL.
* Rows the port writes (``event``, ``event_batch`` with its per-row trace
  override, ``JournalBuffer``) are read back by the reference's
  ``journal.query`` with the same kinds, entities, payloads and
  trace/span ids, and the same sequence of writes leaves the same rows
  in both files: the kind filter, the disable switch and the rowid-window
  prune included.
* ``serve_query`` and ``resolve_trace_prefix`` answer alike on one file.
* ``JournalBuffer``: the bounded queue's drops, the ``journal_disk_full``
  write errors, ``stats()``, the ``skytpu_journal_*`` self-metrics and
  the one ``journal.stall`` row after a ``journal_write_stall``, each as
  the reference's.
"""
import os
import sqlite3

import pytest

from skypilot_tpu.observability import journal as rjournal
from skypilot_tpu.observability import metrics as rmetrics
from skypilot_tpu.utils import chaos as rchaos
from skypilot_tpu_torch.observability import journal as tjournal
from skypilot_tpu_torch.observability import metrics as tmetrics
from skypilot_tpu_torch.utils import chaos as tchaos

SIDES = {'ref': (rjournal, rmetrics, rchaos),
         'port': (tjournal, tmetrics, tchaos)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in (tjournal.DISABLE_ENV, tjournal.ONLY_KINDS_ENV,
                 tjournal.MAX_EVENTS_ENV, tjournal.QUEUE_DEPTH_ENV,
                 tjournal.STALL_SECONDS_ENV, tchaos.CHAOS_ENV):
        monkeypatch.delenv(name, raising=False)
    prev = {k: m.set_registry(m.MetricsRegistry())
            for k, (_, m, _) in SIDES.items()}
    rchaos.reset()
    tchaos.reset()
    yield
    for k, (_, m, _) in SIDES.items():
        m.set_registry(prev[k])
    rchaos.reset()
    tchaos.reset()


def _rows(path, **kwargs):
    """Rows of ``path`` through the reference's reader, oldest first,
    without their timestamps."""
    rows = rjournal.query(db_path=path, limit=10000, ascending=True,
                          **kwargs)
    for r in rows:
        r.pop('ts')
    return rows


def test_vocabulary_and_schema_equal_the_reference(tmp_path):
    assert [(k.name, k.value) for k in tjournal.EventKind] == [
        (k.name, k.value) for k in rjournal.EventKind]
    assert tjournal.KINDS == rjournal.KINDS
    sql = {}
    for side, (mod, _, _) in SIDES.items():
        path = str(tmp_path / f'{side}.db')
        mod.event(mod.EventKind.ENGINE_ADMIT, 'engine:x', {'a': 1},
                  db_path=path)
        with sqlite3.connect(path) as conn:
            sql[side] = sorted(conn.execute(
                'SELECT type, name, tbl_name, sql FROM sqlite_master'
            ).fetchall())
    assert sql['port'] == sql['ref'] and sql['ref']
    with pytest.raises(ValueError, match='Unregistered'):
        tjournal.event('no.such_kind', 'x')


def _write_sequence(mod, path):
    """One sequence of direct and batched writes (ambient trace, explicit
    ids, the batch's string and tuple overrides); returns the batch's
    committed count."""
    mod.event(mod.EventKind.ENGINE_MESH, 'engine:e', {'tp': 1, 'k': [1, 2]},
              ts=1.0, db_path=path)
    mod.event('engine.crash', 'engine:e', {'error': 'boom\nline'},
              trace_id='t1', span_id='s1', parent_span_id='p0', ts=2.0,
              db_path=path)
    n = mod.event_batch([
        (mod.EventKind.ENGINE_ADMIT, 'engine:e', {'request': 'r0'}, 3.0),
        ('engine.evict', 'engine:e', {'request': 'r0', 'generated': 4},
         4.0, 't2'),
        (mod.EventKind.SPAN_START, 'server:e:1', {'name': 'server.request'},
         5.0, ('t3', 's3', 'p3')),
        (mod.EventKind.SPAN_END, 'server:e:1', None, 6.0, ('t3', 's3')),
    ], db_path=path)
    return n


def test_rows_written_by_the_port_read_back_by_the_reference(tmp_path):
    paths = {side: str(tmp_path / f'{side}.db') for side in SIDES}
    assert [_write_sequence(mod, paths[side])
            for side, (mod, _, _) in SIDES.items()] == [4, 4]
    got, want = _rows(paths['port']), _rows(paths['ref'])
    assert got == want
    assert [r['kind'] for r in got] == [
        'engine.mesh', 'engine.crash', 'engine.admit', 'engine.evict',
        'span.start', 'span.end']
    assert got[3]['trace_id'] == 't2' and got[3]['span_id'] is None
    assert (got[4]['trace_id'], got[4]['span_id'],
            got[4]['parent_span_id']) == ('t3', 's3', 'p3')
    assert got[1]['payload'] == {'error': 'boom\nline'}
    assert _rows(paths['port'], trace_id='t3') == _rows(paths['ref'],
                                                        trace_id='t3')


@pytest.mark.parametrize('case', ['only_kinds', 'disabled', 'prune'])
def test_filters_and_prune_match_the_reference(tmp_path, monkeypatch,
                                               case):
    """The kind filter and the disable switch are re-read per call; the
    rowid window keeps the newest MAX_EVENTS rows."""
    if case == 'only_kinds':
        monkeypatch.setenv(tjournal.ONLY_KINDS_ENV,
                           'engine.evict, span.start')
    elif case == 'disabled':
        monkeypatch.setenv(tjournal.DISABLE_ENV, '1')
    else:
        monkeypatch.setenv(tjournal.MAX_EVENTS_ENV, '3')
    paths = {side: str(tmp_path / f'{side}.db') for side in SIDES}
    committed = []
    for side, (mod, _, _) in SIDES.items():
        for i in range(4):
            mod.event(mod.EventKind.ENGINE_STALL, 'engine:e', {'i': i},
                      ts=float(i), db_path=paths[side])
        committed.append(_write_sequence(mod, paths[side]))
    assert committed[0] == committed[1]
    got, want = _rows(paths['port']), _rows(paths['ref'])
    assert got == want
    if case == 'disabled':
        assert got == []
    elif case == 'prune':
        assert len(got) == 3
    else:
        assert {r['kind'] for r in got} == {'engine.evict', 'span.start'}


def test_serve_query_and_trace_prefix_match_the_reference(tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / 'j.db')
    _write_sequence(rjournal, path)
    for i in range(5):
        rjournal.event(rjournal.EventKind.ENGINE_ADMIT, f'engine:e{i % 2}',
                       {'i': i}, trace_id=f'abc{i}', ts=10.0 + i,
                       db_path=path)
    monkeypatch.setenv(tjournal.QUERY_LIMIT_ENV, '4')
    for params in ({}, {'trace_id': 't3'}, {'trace': 'abc2'},
                   {'kinds': 'engine.admit,bogus', 'limit': '2'},
                   {'since_id': '3'}, {'since_id': 'x', 'limit': '99'},
                   {'entity': 'engine:e1'}, {'entity_prefix': 'server:'},
                   {'kinds': ['span.end']}):
        got = tjournal.serve_query(params, db_path=path, host='h')
        assert got == rjournal.serve_query(params, db_path=path,
                                           host='h'), params
    assert tjournal.serve_query({}, db_path=path)['count'] == 4
    for prefix in ('abc', 't', 'abc3', 'zz', '%'):
        assert (tjournal.resolve_trace_prefix(prefix, db_path=path) ==
                rjournal.resolve_trace_prefix(prefix, db_path=path))
    assert tjournal.query(db_path=str(tmp_path / 'none' / 'x.db')) == []


def _buffer_run(mod, met, path, rows):
    buf = mod.JournalBuffer(db_path=path, entity='engine:b')
    kept = [buf.append(kind, 'engine:b', payload, override, ts)
            for kind, payload, override, ts in rows]
    buf.flush()
    stats = buf.stats()
    stats.pop('flush_p95_seconds')
    series = {m.name: m.expose()[2:] for m in met.get_registry().metrics()
              if m.kind == 'counter'}
    return kept, stats, series


ROWS = [(tjournal.EventKind.ENGINE_ADMIT.value, {'request': f'r{i}'},
         (f't{i}', f's{i}', None) if i % 2 else f't{i}', float(i))
        for i in range(5)]


@pytest.mark.parametrize('case', ['plain', 'queue_full', 'disk_full'])
def test_buffer_drops_stats_and_metrics_match_the_reference(
        tmp_path, monkeypatch, case):
    if case == 'queue_full':
        monkeypatch.setenv(tjournal.QUEUE_DEPTH_ENV, '3')
    elif case == 'disk_full':
        monkeypatch.setenv(tchaos.CHAOS_ENV, 'journal_disk_full')
    out = {side: _buffer_run(mod, met, str(tmp_path / f'{side}.db'), ROWS)
           for side, (mod, met, _) in SIDES.items()}
    assert out['port'] == out['ref']
    kept, stats, series = out['port']
    assert stats['appended'] == sum(kept)
    if case == 'queue_full':
        assert kept == [True] * 3 + [False] * 2
        assert series['skytpu_journal_dropped_total'] == [
            'skytpu_journal_dropped_total{reason="queue_full"} 2']
    elif case == 'disk_full':
        assert stats['dropped_write_error'] == 5 and stats['written'] == 0
    else:
        assert stats['written'] == 5
    assert (_rows(str(tmp_path / 'port.db')) ==
            _rows(str(tmp_path / 'ref.db')))


def test_stalled_flush_journals_one_stall_row_on_recovery(tmp_path,
                                                          monkeypatch):
    """A flush past SKYTPU_JOURNAL_STALL_SECONDS notes the stall; the next
    fast flush writes one journal.stall row (through the direct path)
    with the reference's payload keys."""
    monkeypatch.setenv(tjournal.STALL_SECONDS_ENV, '0.2')
    monkeypatch.setenv(tchaos.JOURNAL_STALL_SECONDS_ENV, '0.25')
    rows = {}
    for side, (mod, _, chaos) in SIDES.items():
        path = str(tmp_path / f'{side}.db')
        buf = mod.JournalBuffer(db_path=path, entity='engine:b')
        monkeypatch.setenv(chaos.CHAOS_ENV, 'journal_write_stall')
        buf.append('engine.admit', 'engine:b', {'i': 0})
        buf.flush()
        assert buf.stats()['flush_p95_seconds'] >= 0.25
        monkeypatch.delenv(chaos.CHAOS_ENV)
        buf.append('engine.admit', 'engine:b', {'i': 1})
        buf.flush()
        rows[side] = _rows(path)
    assert ([(r['kind'], sorted(r['payload'])) for r in rows['port']] ==
            [(r['kind'], sorted(r['payload'])) for r in rows['ref']])
    stall = [r for r in rows['port'] if r['kind'] == 'journal.stall']
    assert len(stall) == 1 and stall[0]['entity'] == 'engine:b'
    assert stall[0]['payload']['stalled_flushes'] == 1
    assert stall[0]['payload']['stall_seconds'] >= 0.25


def test_async_flush_coalesces_and_lands_every_row(tmp_path):
    """flush(wait=False) starts at most one writer thread at a time; a
    later flush(wait=True) returns only after every claimed row is
    committed."""
    path = str(tmp_path / 'j.db')
    buf = tjournal.JournalBuffer(db_path=path)
    for i in range(50):
        buf.append('engine.evict', 'engine:b', {'i': i})
        buf.flush(wait=False)
    buf.flush()
    got = _rows(path)
    assert [r['payload']['i'] for r in got] == list(range(50))
    assert buf.stats()['written'] == 50
    assert os.path.exists(path)


def test_journal_path_and_knobs_read_as_the_reference(tmp_path,
                                                      monkeypatch):
    """SKYTPU_JOURNAL_PATH, _MAX_EVENTS, _QUEUE_DEPTH, _STALL_SECONDS and
    _QUERY_LIMIT parse as the reference's (bad values: the defaults), and
    a host-journal write lands where the path says."""
    cases = {tjournal.DB_PATH_ENV: ('~/j/x.db', str(tmp_path / 'h.db')),
             tjournal.MAX_EVENTS_ENV: ('7', 'x'),
             tjournal.QUEUE_DEPTH_ENV: ('3', ''),
             tjournal.STALL_SECONDS_ENV: ('0.5', 'y'),
             tjournal.QUERY_LIMIT_ENV: ('9', '1.5')}
    readers = ('db_path', 'max_events', 'queue_depth', 'stall_seconds',
               'query_limit')
    for name, values in cases.items():
        for value in values:
            monkeypatch.setenv(name, value)
            assert ([getattr(tjournal, r)() for r in readers] ==
                    [getattr(rjournal, r)() for r in readers]), (name, value)
    monkeypatch.delenv(tjournal.DB_PATH_ENV)
    assert tjournal.db_path() == rjournal.db_path()
    monkeypatch.setenv(tjournal.DB_PATH_ENV, str(tmp_path / 'h.db'))
    tjournal.event(tjournal.EventKind.SERVER_DRAIN, 'server:x:1',
                   {'phase': 'begin'})
    assert [r['kind'] for r in _rows(str(tmp_path / 'h.db'))] == [
        'server.drain']
