"""The traffic generators: deterministic by seed, the same work for every
seed, the stated medians and clips."""
import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from portbench.generators import open_loop, uniform_batches

PB = Path(__file__).resolve().parents[1]
CHAT = json.loads((PB / 'traffic' / 'chat.json').read_text())
PRETRAIN = json.loads((PB / 'traffic' / 'pretrain.json').read_text())


def test_schedule_is_deterministic_by_seed():
    a = open_loop.schedule(CHAT, 6.0, 10.0, 2**31 + 11, 32768)
    b = open_loop.schedule(CHAT, 6.0, 10.0, 2**31 + 11, 32768)
    c = open_loop.schedule(CHAT, 6.0, 10.0, 2**31 + 12, 32768)
    assert a == b
    assert [r['prompt'] for r in a] != [r['prompt'] for r in c]


@pytest.mark.parametrize('seed', [0, 7, 2**31 + 3, 2**40])
def test_every_seed_gets_the_same_schedule(seed):
    """Lengths and due times in one order for every seed; the ids
    differ."""
    base = open_loop.schedule(CHAT, 6.0, 10.0, 1, 32768)
    got = open_loop.schedule(CHAT, 6.0, 10.0, seed, 32768)

    def work(reqs):
        return [(r['due'], len(r['prompt']), r['max_new_tokens'],
                 r['counted']) for r in reqs]

    assert work(base) == work(got)
    assert [r['prompt'] for r in base] != [r['prompt'] for r in got]


def test_the_schedule_is_the_mixs_own():
    other = dict(CHAT, schedule_seed=CHAT['schedule_seed'] + 1)
    a = open_loop.schedule(CHAT, 6.0, 10.0, 1, 32768)
    b = open_loop.schedule(other, 6.0, 10.0, 1, 32768)
    assert sorted(len(r['prompt']) for r in a) == sorted(
        len(r['prompt']) for r in b)
    assert [len(r['prompt']) for r in a] != [len(r['prompt']) for r in b]


def test_lengths_have_the_stated_medians_and_clips():
    n = 1001
    pr, out = CHAT['prompt'], CHAT['output']
    p = open_loop.lognormal_quantiles(n, pr['median'], pr['sigma'],
                                      pr['min'], pr['max'])
    o = open_loop.lognormal_quantiles(n, out['median'], out['sigma'],
                                      out['min'], out['max'])
    assert statistics.median(p) == pr['median']
    assert statistics.median(o) == out['median']
    assert p.min() >= pr['min'] and p.max() == pr['max']
    assert o.min() == out['min'] and o.max() == out['max']
    # The share the top clip takes, as the mix's file states it.
    assert abs((p == pr['max']).mean() - 0.081) < 0.002
    assert abs((o == out['max']).mean() - 0.025) < 0.002
    # sigma 0.9: the 84th percentile is e^0.9 times the median.
    assert abs(np.percentile(p, 84.13) / pr['median'] - np.exp(0.9)) < 0.05


def test_window_requests_span_the_window_at_the_rate():
    reqs = open_loop.schedule(CHAT, 6.4, 35.0, 5, 32768)
    counted = [r for r in reqs if r['counted']]
    warm = [r for r in reqs if not r['counted']]
    assert len(counted) == round(6.4 * 35.0)
    assert len(warm) == round(6.4 * CHAT['warm_seconds'])
    assert min(r['due'] for r in counted) == 0.0
    assert max(r['due'] for r in counted) < 35.0
    assert all(-CHAT['warm_seconds'] <= r['due'] < 0 for r in warm)
    assert all(0 <= t < 32768 for r in reqs for t in r['prompt'])
    assert len({r['id'] for r in reqs}) == len(reqs)


def test_warm_lengths_reach_every_power_of_two_bucket():
    lengths = open_loop.warm_lengths(CHAT)
    assert lengths == [32, 64, 128, 256, 512, 1024, 2048, 3584]


def test_percentile_is_nearest_rank_and_inf_sorts_last():
    vals = list(range(1, 101))
    assert open_loop.percentile(vals, 95) == 95
    assert open_loop.percentile(vals[:-1] + [float('inf')], 100) == float(
        'inf')


def test_training_batches_are_deterministic_and_fresh():
    t1, y1 = uniform_batches.batch(PRETRAIN, 9, 0, 32000, 'cpu')
    t2, _ = uniform_batches.batch(PRETRAIN, 9, 0, 32000, 'cpu')
    t3, _ = uniform_batches.batch(PRETRAIN, 9, 1, 32000, 'cpu')
    assert t1.shape == (PRETRAIN['batch'], PRETRAIN['seq_len'])
    assert (t1 == t2).all() and not (t1 == t3).all()
    assert (y1[:, :-1] == t1[:, 1:]).all()
    assert len({tuple(r.tolist()) for r in t1}) == PRETRAIN['batch']
    assert uniform_batches.tokens_per_step(PRETRAIN) == 4 * 2048
