"""The controls come out not correct under each cell's own limits, at a
size the CPU holds (``portbench/control.py`` reads them on the card at
the cells' sizes).

Serving: the replica with the program's own lower-precision path on
(int8 weights, ``decode.quantize_params``) serves the cell's traffic at
the cell's depth and a narrow width, and its served tokens' widest gap
under the fp32 reference fails ``served_logit_gap``. Training: the reference computed in fp8
(``reference.fp8_mm``) put in the program's place fails one of the
cell's numbers against the fp32 reference."""
import time

from skypilot_tpu_torch.models import decode

from portbench import reference, weights
from portbench.generators import open_loop
from portbench.kinds import serve, train
from portbench_tiny import narrow_serve_cell, tiny_train_cell

SEED = 2**31 + 23


def test_int8_weights_replica_fails_the_serving_limit():
    cell = narrow_serve_cell()
    d = weights.dims_of(cell.config)
    params = weights.make_params(d, SEED, 'cpu')
    eng, server, port = serve.start_replica(
        d, cell.config['deployment'], decode.quantize_params(params), SEED,
        cell.name)
    try:
        ctx, proc = serve.window_run(port, cell, d, SEED, 2.0, None,
                                     time.monotonic())
        ctx.records = serve.finish_load(proc)
    finally:
        server.stop()
        eng.close()
    prompts = {r['id']: r['prompt'] for r in open_loop.schedule(
        cell.traffic, cell.spec['rate_per_s'], 2.0, SEED, d.vocab)}
    sample = serve.check_sample(ctx.records, SEED, cell.spec['check_tokens'])
    got = serve.check_served(params, d, sample, prompts)
    assert got['served_logit_gap'] > cell.spec['limits']['served_logit_gap']


def test_fp8_reference_fails_a_training_limit():
    cell = tiny_train_cell()
    d = weights.dims_of(cell.config)
    opt = cell.config['deployment']['optimizer']
    want = train.reference_readings(d, SEED, cell.traffic, opt, 'cpu')
    ctl = train.reference_readings(d, SEED, cell.traffic, opt, 'cpu',
                                   mm=reference.fp8_mm)
    numbers = train.compare(ctl, want)
    limits = cell.spec['limits']
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_routing_diagnosis_reads_the_programs_routing(capsys):
    """``control.py --routing``: the reference made to take the
    program's routing reads ``grad_diff`` no higher than on its own."""
    import json

    from portbench import control
    control.train_routing(tiny_train_cell(), [3], device='cpu')
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row['tokens'] == 2 * 64
    assert (row['program_routing']['grad_diff'] <=
            row['own_routing']['grad_diff'])
    assert row['own_routing']['grad_diff_leaf'].startswith('layers/')
