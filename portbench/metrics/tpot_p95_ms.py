"""95th percentile, over every request due in the window, of (last
token's time − first token's time) / (tokens − 1) at the client: the
streaming speed a user sees. A request that failed counts as slower
than any (host clock)."""
from portbench.generators import open_loop
from portbench.kinds import serve


def read(ctx):
    return 1e3 * open_loop.percentile(serve.tpots(ctx), 95)
