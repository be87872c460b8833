"""95th percentile of the admission queue's wait (enqueue to admission)
over the window's requests, from the engine's own request records
(``RequestTelemetry``, read through ``/debug/requests``). In a traced
run, requests alive while the profiler held the engine are left out."""
from portbench.generators import open_loop


def read(ctx):
    waits = [r['phases']['queue_wait'] for r in ctx.unheld_requests()
             if r['phases'].get('queue_wait') is not None]
    if not waits:
        return None
    return 1e3 * open_loop.percentile(waits, 95)
