"""95th percentile, over every request due in the window, of the time
from its due time to its first streamed token at the client; a request
that failed counts as slower than any (host clock)."""
from portbench.generators import open_loop
from portbench.kinds import serve


def read(ctx):
    return 1e3 * open_loop.percentile(serve.ttfts(ctx), 95)
