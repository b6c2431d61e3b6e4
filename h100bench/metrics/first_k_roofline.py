"""First-k ball-query kernels: the profiled steps' summed bound over
their summed device time, in percent."""

from h100bench.work import ball_query, share_pct


def read(r):
    return share_pct(r, ball_query.KERNELS, ball_query.sites_bound_s(r.sites))
