"""The readings that a cell's limits are set from: the program's sound
runs over many seeds, the control's (the plain reference computed in
fp8 put in the program's place) and the faults', at the cell's own
size, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--seconds 10]
    python3 portbench/control.py --workload mixtral8x7b.train --seeds 1,2,3 --routing

Serving: the replica is built once; for each seed its weights are drawn
again in place, the cell's traffic runs for ``--seconds`` at the cell's
rate, and the sampled requests are checked as a run checks them
(``served_logit_gap``); for the control seeds the same reference pass
also reads ``control_logit_gap``, the gap of the token the fp8
reference puts first at each position of the same prompts and tokens,
and then a replica with the program's int8 weights serves the same
traffic, whose ``served_logit_gap`` is the control's reading.
Training: for each seed the program's first steps against the
reference's (``train.compare``); for the control seeds also the fp8
reference's readings and those of the reference with half of each batch
left out, both against the fp32 reference. A step that leaves its state
unchanged reads 1 in ``param_change_gap`` by construction and needs no
run.

With ``--routing`` (training), a diagnosis of ``grad_diff`` instead:
for each seed the program's routing in its first step (each token's
top-k experts and whether capacity kept each choice, layer by layer),
how many tokens the fp32 reference routes otherwise, and ``grad_diff``
with its leaf, once against the reference on its own routing and once
against the reference made to take the program's.

Prints one JSON line a seed; the benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# pylint: disable=wrong-import-position
from portbench import harness, reference, weights  # noqa: E402
from portbench.generators import open_loop  # noqa: E402


def _serve_seed(cell, d, params, port, seed, seconds, fp8: bool,
                label: str) -> None:
    from portbench.kinds import serve
    ctx, proc = serve.window_run(
        port, cell, d, seed, seconds, None, time.monotonic())
    ctx.records = serve.finish_load(proc)
    prompts = {r['id']: r['prompt'] for r in open_loop.schedule(
        cell.traffic, float(cell.spec['rate_per_s']), seconds, seed,
        d.vocab)}
    sample = serve.check_sample(ctx.records, seed, cell.spec['check_tokens'])
    t0 = time.monotonic()
    got = serve.check_served(params, d, sample, prompts, control=fp8)
    print(json.dumps({
        'seed': seed, 'replica': label, **got, 'requests': len(sample),
        'served_tokens': sum(len(r['tokens']) for r in sample),
        'failed': sum(serve.failed(r) for r in ctx.counted),
        'reference_s': time.monotonic() - t0}), flush=True)


def serve_readings(cell, seeds, control_seeds, seconds) -> None:
    """The bf16 replica on every seed (the fp8 reference's reading beside
    it on the control seeds), then on the control seeds the replica with
    the program's own lower-precision path switched on: int8 weights
    (``decode.quantize_params``), whose ``served_logit_gap`` is the
    control's reading."""
    from skypilot_tpu_torch.models import decode
    from portbench.kinds import serve
    d = weights.dims_of(cell.config)
    dep = cell.config['deployment']
    params = weights.make_params(d, seeds[0], 'cuda')
    eng, server, port = serve.start_replica(d, dep, params, seeds[0],
                                            cell.name)
    try:
        serve.warm_shapes(port, cell.traffic, d.vocab)
        for seed in seeds:
            weights.refill_params(params, d, seed)
            _serve_seed(cell, d, params, port, seed, seconds,
                        seed in control_seeds, 'bf16')
    finally:
        server.stop()
        eng.close()
    del eng, server
    gc.collect()
    for seed in sorted(control_seeds):
        weights.refill_params(params, d, seed)
        qparams = decode.quantize_params(params)
        eng, server, port = serve.start_replica(d, dep, qparams, seed,
                                                cell.name)
        try:
            serve.warm_shapes(port, cell.traffic, d.vocab)
            _serve_seed(cell, d, params, port, seed, seconds, False,
                        'int8_weights')
        finally:
            server.stop()
            eng.close()
        del eng, server, qparams
        gc.collect()


def train_readings(cell, seeds, control_seeds) -> None:
    import torch
    from portbench.generators import uniform_batches
    from portbench.kinds import train
    for seed in seeds:
        d, dep, tcfg, step_fn, state = train.build(cell, seed, 'cuda')
        t0 = time.monotonic()
        state, got = train.program_readings(
            step_fn, state,
            lambda i, s=seed: uniform_batches.batch(cell.traffic, s, i,
                                                    d.vocab, 'cuda'),
            d, seed, tcfg.beta1)
        program_s = time.monotonic() - t0
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        want = train.reference_readings(d, seed, cell.traffic,
                                        dep['optimizer'], 'cuda')
        reference_s = time.monotonic() - t0
        row = {'seed': seed, **train.compare(got, want, 'cuda'),
               'program_s': program_s, 'reference_s': reference_s,
               'losses': got['losses'], 'reference_losses': want['losses']}
        del got
        if seed in control_seeds:
            for name, kw in (('control', {'mm': reference.fp8_mm}),
                             ('half_batch', {'fault': 'half_batch'})):
                other = train.reference_readings(
                    d, seed, cell.traffic, dep['optimizer'], 'cuda', **kw)
                row[name] = train.compare(other, want, 'cuda')
                row[name]['losses'] = other['losses']
                del other
        print(json.dumps(row), flush=True)
        del want
        gc.collect()
        torch.cuda.empty_cache()


def train_routing(cell, seeds, device='cuda') -> None:
    import torch
    from skypilot_tpu_torch.models import moe
    from portbench.generators import uniform_batches
    from portbench.kinds import train
    for seed in seeds:
        d, dep, tcfg, step_fn, state = train.build(cell, seed, device)
        program, assign = [], moe._assign

        def recording(probs, cfg):
            combine, onehot = assign(probs, cfg)
            if len(program) < d.n_layers:  # the first step's forward
                with torch.no_grad():  # saves nothing for the backward
                    idx = onehot.argmax(-1)
                    kept = combine.detach().sum(-1).gather(1, idx) > 0
                    program.append((idx.cpu(), kept.cpu()))
            return combine, onehot

        moe._assign = recording
        try:
            state, got = train.program_readings(
                step_fn, state,
                lambda i, s=seed: uniform_batches.batch(
                    cell.traffic, s, i, d.vocab, device),
                d, seed, tcfg.beta1)
        finally:
            moe._assign = assign
        del state, step_fn
        gc.collect()
        if device != 'cpu':
            torch.cuda.empty_cache()
        own = []
        want = train.reference_readings(d, seed, cell.traffic,
                                        dep['optimizer'], device, seen=own,
                                        steps=1)
        forced = train.reference_readings(d, seed, cell.traffic,
                                          dep['optimizer'], device,
                                          routing=program, steps=1)
        row = {'seed': seed, 'tokens': int(program[0][0].shape[0])}
        for layer, ((pi, pk), (oi, ok)) in enumerate(zip(program, own)):
            oi, ok = oi.cpu(), ok.cpu()
            row[f'layer{layer}_tokens_routed_otherwise'] = int(
                ((pi != oi) | (pk != ok)).any(-1).sum())
            row[f'layer{layer}_experts_otherwise'] = int(
                (pi != oi).any(-1).sum())
        for name, ref in (('own_routing', want), ('program_routing',
                                                  forced)):
            numbers = train.compare(got, ref, device)
            row[name] = {k: numbers[k] for k in
                         ('grad_diff', 'grad_diff_leaf', 'grad_norm_gap')}
        print(json.dumps(row), flush=True)
        del got, want, forced
        gc.collect()
        if device != 'cpu':
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--seconds', type=float, default=10.0)
    parser.add_argument('--routing', action='store_true')
    args = parser.parse_args()
    harness.prepare_environment()
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(',')]
    control = {int(s) for s in args.control_seeds.split(',') if s}
    if cell.kind == 'serve':
        serve_readings(cell, seeds, control, args.seconds)
    elif args.routing:
        train_routing(cell, seeds)
    else:
        train_readings(cell, seeds, control)
    return 0


if __name__ == '__main__':
    sys.exit(main())
