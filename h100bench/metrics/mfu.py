"""The whole step's share of the float32 peak: the model's operations per
step (``h100bench/flops.py``) times the steps of the traced run's window
after the profiler closed, over that time and 67 TFLOP/s, in percent."""

from h100bench.harness import PEAK_F32_FLOPS


def read(r):
    if not r.trace.in_steps():
        return None
    return (100.0 * r.flops_per_step * r.window_steps / r.window_s
            / PEAK_F32_FLOPS)
