"""The whole model step's share of the card's bf16 peak over the
window: the forward operations the window's served tokens needed
(``peaks.serve_flops``: 2 per weight per prompt token prefilled and per
token decoded, plus causal attention) over the window's seconds and
989 TFLOP/s. A prompt counts when its first token came in the window, a
decoded token when it did; in a traced run the seconds the profiler held
the engine count neither in the tokens nor in the window."""
from portbench import peaks


def read(ctx):
    t0, t1 = ctx.window
    d = ctx.dims
    prompts, positions = [], []
    for r in ctx.records:
        for k, t in enumerate(r['times']):
            if not t0 <= t <= t1 or not ctx.clear(t, t):
                continue
            if k == 0:
                prompts.append(r['prompt_len'])
            else:
                positions.append(r['prompt_len'] + k)
    if not prompts and not positions:
        return None
    flops = peaks.serve_flops(ctx.active_params(), d.n_layers, d.n_heads,
                              d.head_dim, prompts, positions)
    return 100.0 * flops / (ctx.unheld_seconds() * peaks.PEAK_BF16_FLOPS)
