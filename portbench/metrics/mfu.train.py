"""The whole train step's share of the card's bf16 peak: the operations
each token needs (``peaks.train_flops_per_token``: 6 per weight it
passes through, the router and its ``top_k`` experts and the output head
included, plus causal attention; no recomputation, no dispatch) times
the tokens per second of the window's unprofiled steps, over 989
TFLOP/s."""
from portbench import peaks


def read(ctx):
    if ctx.unprofiled_steps <= 0 or ctx.unprofiled_s <= 0:
        return None
    d = ctx.dims
    per_token = peaks.train_flops_per_token(
        ctx.active_params(), d.n_layers, d.n_heads, d.head_dim,
        ctx.traffic['seq_len'])
    tps = ctx.unprofiled_steps * ctx.tokens_per_step / ctx.unprofiled_s
    return 100.0 * per_token * tps / peaks.PEAK_BF16_FLOPS
