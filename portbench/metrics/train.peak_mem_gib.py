"""Peak device memory allocated during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in
GiB: the train state and the step's activations."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
