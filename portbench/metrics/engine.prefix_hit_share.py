"""Share of the window's prompt tokens that the radix prefix cache
served, from the engine's request records (prefix hit tokens over prompt
tokens, ``RequestTelemetry`` through ``/debug/requests``)."""


def read(ctx):
    prompt = sum(r['prompt_len'] for r in ctx.requests)
    if not prompt:
        return None
    return 100.0 * sum(r['prefix_hit_tokens'] for r in ctx.requests) / prompt
