"""decode_p95_ms: the 95th percentile of the wall time of every decode call
that started in the window, across all clients, each waited for; a failed
call counts as missing every limit (None: the metric is left out, and the
run's check fails on it)."""

import math

from cfbench.stats import percentile


def read(ctx):
    times = [(r.end - r.start) * 1e3 if r.ok else math.inf
             for r in ctx.records if ctx.start <= r.start <= ctx.end]
    if not times:
        return None
    p95 = percentile(times, 95)
    return None if math.isinf(p95) else p95
