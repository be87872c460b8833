"""The flash-attention backward kernels' (dq and dk/dv together) share
of their roofline in the traced steps: the causal backward's operations
at the cell's shapes (``peaks.flash_backward_flops``: five products, the
attention matrix recomputed once), a layer a step, over 989 TFLOP/s,
against the device time of the kernels the trace names as the flash
backward."""
from portbench import peaks


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    spent = ctx.trace.device_seconds(lambda n: 'flash_bwd' in n)
    if spent <= 0:
        return None
    d, tr = ctx.dims, ctx.traffic
    flops = (ctx.traced_steps * d.n_layers *
             peaks.flash_backward_flops(tr['batch'], tr['seq_len'],
                                        d.n_heads, d.head_dim))
    return 100.0 * flops / peaks.PEAK_BF16_FLOPS / spent
