"""Open-loop request traffic: arrivals on a fixed schedule, whatever
the server does.

A traffic file (``portbench/traffic/<name>.json``) gives the mix's
shape; the cell gives the rate. The schedule of one mix, rate and length
is the same for every seed: the prompt and output lengths are the
quantiles of their lognormals at ``(i + 0.5) / n`` and the gaps between
arrivals those of an exponential, scaled so the ``n`` arrivals span the
phase exactly, each list in an order drawn once from the mix's
``schedule_seed``. The run's seed draws the token ids. (Runs whose seeds
also ordered the lengths and gaps read tails that differed by 20% from
seed to seed and by 4% between two runs of one seed: which long prompt
lands beside which decode sets the tail.)

Keys of a traffic file read here:

* ``prompt`` / ``output``: ``{"median", "sigma", "min", "max"}`` of a
  lognormal length, clipped;
* ``arrivals``: ``"poisson"``;
* ``schedule_seed``: the order of the lengths and gaps;
* ``warm_seconds``: seconds of the same traffic sent before the window
  opens (set-up), so the window starts with the slots filled.
"""
import math
import statistics
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    """``n`` lengths: the lognormal's quantiles at (i + 0.5) / n,
    rounded and clipped to [lo, hi]."""
    z = np.array([_NORMAL.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def exponential_gaps(n: int, span: float) -> np.ndarray:
    """``n`` gaps with the shape of an exponential's quantiles, scaled to
    add up to ``span`` seconds."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    return gaps * (span / gaps.sum())


def _rng(seed: int, phase: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, phase]))


def _phase(traffic: Dict, n: int, t0: float, span: float, seed: int,
           phase: int, vocab: int, counted: bool) -> List[Dict]:
    if n <= 0:
        return []
    order = _rng(traffic['schedule_seed'], phase)
    pr, out = traffic['prompt'], traffic['output']
    prompts = order.permutation(lognormal_quantiles(
        n, pr['median'], pr['sigma'], pr['min'], pr['max']))
    outputs = order.permutation(lognormal_quantiles(
        n, out['median'], out['sigma'], out['min'], out['max']))
    gaps = order.permutation(exponential_gaps(n, span))
    rng = _rng(seed, phase)
    # The first request is due at the phase's start; the gaps after it
    # (the last gap closes the span) place the rest.
    due = t0 + np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return [{'due': float(due[i]),
             'prompt': rng.integers(0, vocab, int(prompts[i]),
                                    dtype=np.int64).tolist(),
             'max_new_tokens': int(outputs[i]),
             'counted': counted}
            for i in range(n)]


def schedule(traffic: Dict, rate: float, seconds: float, seed: int,
             vocab: int) -> List[Dict]:
    """Every request of a run, warm-up first: ``due`` in seconds from
    the window's opening (negative in the warm-up), the prompt's ids,
    ``max_new_tokens``, and whether it is ``counted`` (due inside the
    window)."""
    if traffic.get('arrivals', 'poisson') != 'poisson':
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    warm = float(traffic.get('warm_seconds', 0.0))
    n_warm = int(round(rate * warm))
    n = max(1, int(round(rate * seconds)))
    reqs = _phase(traffic, n_warm, -warm, warm, seed, 0, vocab, False)
    reqs += _phase(traffic, n, 0.0, seconds, seed, 1, vocab, True)
    for i, r in enumerate(reqs):
        r['id'] = f'{seed}-{i}'
    return reqs


def warm_lengths(traffic: Dict) -> List[int]:
    """Prompt lengths set-up sends before any traffic: every power of
    two inside the mix's clip and its largest length, so each prefill
    shape the traffic can reach runs once before the window."""
    lo, hi = traffic['prompt']['min'], traffic['prompt']['max']
    lengths = {hi}
    b = 1
    while b <= hi:
        if b >= lo:
            lengths.add(b)
        b *= 2
    return sorted(lengths)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (``inf`` entries sort
    last)."""
    vals = sorted(values)
    if not vals:
        return math.nan
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]
