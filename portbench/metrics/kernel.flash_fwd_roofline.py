"""The flash-attention forward kernel's share of its roofline in the
traced steps: the causal forward's operations at the cell's shapes
(``peaks.flash_forward_flops``), once a layer for the forward and once
more for the recomputation that the job's ``remat_policy: full`` asks
of the backward, over 989 TFLOP/s, against the device time of the
kernels the trace names as the flash forward."""
from portbench import peaks


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    spent = ctx.trace.device_seconds(lambda n: 'flash_fwd' in n)
    if spent <= 0:
        return None
    d, tr = ctx.dims, ctx.traffic
    passes = 2 if ctx.deployment['remat_policy'] == 'full' else 1
    flops = (ctx.traced_steps * d.n_layers * passes *
             peaks.flash_forward_flops(tr['batch'], tr['seq_len'],
                                       d.n_heads, d.head_dim))
    return 100.0 * flops / peaks.PEAK_BF16_FLOPS / spent
