"""Device kernels per request or train step, from the trace of the
profiled steps."""

from h100bench.trace import kernels


def read(r):
    n = len(kernels(r.trace.in_steps()))
    return n / r.steps if n else None
