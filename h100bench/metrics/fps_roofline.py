"""FPS kernels: the profiled steps' summed bound over their summed device
time, in percent."""

from h100bench.work import fps, share_pct


def read(r):
    return share_pct(r, fps.KERNELS, fps.sites_bound_s(r.sites))
