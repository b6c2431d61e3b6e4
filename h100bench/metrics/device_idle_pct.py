"""The share of a step's time in which no operation ran on the device:
100 x (1 - the device's busy time per profiled step, the union of its
operations' intervals, over the seconds per step of the window's untraced
rest).  The profiler's host-side recording stretches the profiled steps'
own wall time, so their pace is taken from the steps after it."""

from h100bench.trace import busy_us


def read(r):
    ops = r.trace.in_steps()
    if not ops or not r.window_steps:
        return None
    busy_per_step = busy_us(ops) / 1e6 / r.steps
    return 100.0 * (1.0 - busy_per_step * r.window_steps / r.window_s)
