"""The decode-attention kernels' share of their roofline in the traced
window: the least time the card could take for the work the window's
decode steps needed (each live K and V row read once a step, q and the
output once, ``peaks.decode_attention_bytes``; or their operations, if
more), over the device time of the kernels the trace names as decode
attention and the combine of their partials.

The work is counted from the tokens the client received inside the
traced window: the step that made a request's token ``k`` (``k`` ≥ 1)
attended over its prompt and ``k`` positions, in every layer."""
from portbench import peaks

NAMES = ('decode_attention', 'combine_partials')


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.device_seconds(lambda n: any(k in n for k in NAMES))
    if spent <= 0:
        return None
    d = ctx.dims
    m0, m1 = ctx.trace_window
    lens = [r['prompt_len'] + k for r in ctx.records
            for k, t in enumerate(r['times']) if k >= 1 and m0 <= t <= m1]
    if not lens:
        return None
    # One call a layer a step; the sum over the tokens equals the sum
    # over the steps of each step's live lanes.
    need_bytes = d.n_layers * peaks.decode_attention_bytes(
        lens, d.n_heads, d.n_kv_heads, d.head_dim)
    need_flops = d.n_layers * peaks.decode_attention_flops(
        lens, d.n_heads, d.head_dim)
    least = max(need_bytes / peaks.HBM_BYTES_PER_S,
                need_flops / peaks.PEAK_BF16_FLOPS)
    return 100.0 * least / spent
