"""Find a serving cell's knee: the highest offered rate the replica
sustains without a growing backlog.

    python3 portbench/knee.py --workload mistral7b.chat --rates 2,3,4 --runs 2 --seconds 51

One replica, built once; each rate in turn, ``--runs`` times with
another seed each time, drives the cell's traffic for ``--seconds``
(after the mix's warm-up), waits for its requests, and prints one JSON
line a run: ``ttft_p95_ms``, ``tpot_p95_ms``, requests due and
completed, the backlog (requests due and not finished) at the window's
middle and close, the queue (requests due and not yet streaming) and
its least-squares slope over the window sampled each second
(``queue_slope``, requests/s), the requests finished inside the window a
second (``finished_per_s``: the replica's capacity once it saturates),
the admission queue's p95 wait, the slots in use, and the share of the
K/V pool that live requests hold (``kv_live_share_mean``; the engine's
own ``blocks_used`` also counts what the prefix cache keeps). A rate is
sustained when every run of it completed every request, its queue's
slope stayed under ``SLOPE_SHARE`` of the rate and it finished at least
``FINISHED_SHARE`` of the rate a second; the last line names the
highest rate up to which every rate was (``knee``). The replica drains
between runs; a rate it cannot drain within two minutes ends the sweep;
one that is not sustained does not. The cell's rate is then 0.8 of the
knee, written into its workload file by hand.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# pylint: disable=wrong-import-position
from portbench import harness, weights  # noqa: E402
from portbench.generators import open_loop  # noqa: E402
from portbench.kinds import serve  # noqa: E402


# A queue that grows by more than this share of the offered rate, or a
# window that finishes fewer than this share of the rate's requests a
# second, is not sustained. (The share finished reads a little under 1
# where the rate is sustained: the mix's warm-up leaves fewer requests in
# service at the window's opening than at its close.)
SLOPE_SHARE = 0.05
FINISHED_SHARE = 0.95


def backlog(records, t: float) -> int:
    return sum(1 for r in records if r['due'] <= t and
               (serve.failed(r) or r['times'][-1] > t))


def queued(records, t: float) -> int:
    """Requests due by ``t`` whose first token had not come."""
    return sum(1 for r in records if r['due'] <= t and
               (not r['times'] or r['times'][0] > t))


def slope(f, records, t0: float, t1: float) -> float:
    """Least-squares slope (requests/s) of ``f(records, t)`` sampled
    each second of [t0, t1]."""
    ts = np.arange(t0, t1 + 1e-9, 1.0)
    ys = np.array([f(records, t) for t in ts], dtype=float)
    return float(np.polyfit(ts - t0, ys, 1)[0])


def kv_live_share(records, t0: float, t1: float, block_k: int,
                  blocks: int) -> float:
    """Mean share of the pool's ``blocks`` that requests streaming at
    each second of [t0, t1] hold (their prompt and the tokens they had
    received, in blocks of ``block_k``)."""
    shares = []
    for t in np.arange(t0, t1 + 1e-9, 1.0):
        held = 0
        for r in records:
            times = r['times']
            if times and times[0] <= t < times[-1]:
                got = int(np.searchsorted(times, t, side='right'))
                held += -(-(r['prompt_len'] + got) // block_k)
        shares.append(held / blocks)
    return float(np.mean(shares))


def slots_use(steps) -> dict:
    """The slots in use over the window's engine steps."""
    if not steps:
        return {}
    return {'active_slots_mean': float(np.mean(
                [s['active_slots'] for s in steps])),
            'active_slots_max': int(max(s['active_slots'] for s in steps))}


def drain(port: int, timeout: float = 120.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        s = serve.http_json(port, 'GET', '/stats')
        if s['queue_depth'] == 0 and s['active_slots'] == 0:
            return True
        time.sleep(0.5)
    return False


def sweep_run(port: int, cell, d, seed: int, seconds: float,
              t_start: float) -> dict:
    ctx, proc = serve.window_run(port, cell, d, seed, seconds, None,
                                 t_start)
    ctx.records = serve.finish_load(proc)
    serve.read_engine(port, ctx)
    t0, t1 = ctx.window
    counted = ctx.counted
    dep = cell.config['deployment']
    waits = [r['phases']['queue_wait'] for r in ctx.requests
             if r['phases'].get('queue_wait') is not None]
    return {
        'seed': seed, 'due': len(counted),
        'completed': sum(not serve.failed(r) for r in counted),
        'ttft_p95_ms': 1e3 * open_loop.percentile(serve.ttfts(ctx), 95),
        'ttft_p50_ms': 1e3 * open_loop.percentile(serve.ttfts(ctx), 50),
        'tpot_p95_ms': 1e3 * open_loop.percentile(serve.tpots(ctx), 95),
        'backlog_mid': backlog(ctx.records, (t0 + t1) / 2),
        'backlog_end': backlog(ctx.records, t1),
        'queue_mid': queued(ctx.records, (t0 + t1) / 2),
        'queue_end': queued(ctx.records, t1),
        'queue_slope': slope(queued, ctx.records, t0, t1),
        'finished_per_s': sum(
            1 for r in ctx.records if not serve.failed(r) and
            t0 <= r['times'][-1] <= t1) / (t1 - t0),
        'queue_wait_p95_ms': (1e3 * open_loop.percentile(waits, 95)
                              if waits else None),
        'late_send_p95_ms': 1e3 * open_loop.percentile(
            [r['sent'] - r['due'] for r in counted
             if r['sent'] is not None], 95),
        'kv_live_share_mean': kv_live_share(
            ctx.records, t0, t1, dep['block_k'],
            dep['num_slots'] * dep['max_len'] // dep['block_k']),
        **slots_use(ctx.steps)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--rates', required=True)
    parser.add_argument('--seconds', type=float, default=30.0)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--runs', type=int, default=2)
    args = parser.parse_args()
    t_start = time.monotonic()
    harness.prepare_environment()
    cell = harness.load_cell(args.workload)
    d = weights.dims_of(cell.config)
    params = weights.make_params(d, args.seed, 'cuda')
    eng, server, port = serve.start_replica(
        d, cell.config['deployment'], params, args.seed, cell.name)
    sustained, knee, run = {}, None, 0
    try:
        serve.warm_shapes(port, cell.traffic, d.vocab)
        print(json.dumps({'setup_s': time.monotonic() - t_start}),
              flush=True)
        for rate in (float(r) for r in args.rates.split(',')):
            cell.spec['rate_per_s'] = rate
            ok, drained = True, True
            for _ in range(args.runs):
                run += 1
                row = sweep_run(port, cell, d, args.seed + run,
                                args.seconds, t_start)
                row['rate'] = rate
                ok = ok and (row['completed'] == row['due'] and
                             row['queue_slope'] < SLOPE_SHARE * rate and
                             row['finished_per_s'] >= FINISHED_SHARE * rate)
                print(json.dumps(row), flush=True)
                if not drain(port):
                    print(json.dumps({'rate': rate, 'drained': False}),
                          flush=True)
                    drained = False
                    break
            sustained[rate] = ok and drained
            if all(sustained.values()):
                knee = rate
            if not drained:
                break
    finally:
        server.stop()
        eng.close()
    print(json.dumps({'sustained': sustained, 'knee': knee}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
