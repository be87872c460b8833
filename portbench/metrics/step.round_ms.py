"""Mean wall time of the engine's steps inside the window (a step: the
chunked-prefill share and one round of ``step_chunk`` decode steps),
from the engine's step profile (``EngineStepProfiler`` through
``/debug/engine``). In a traced run, steps while the profiler held the
engine are left out."""


def read(ctx):
    steps = ctx.unheld_steps()
    if not steps:
        return None
    return 1e3 * sum(s['step_seconds'] for s in steps) / len(steps)
