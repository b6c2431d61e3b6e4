"""The host's own ms inside the program's step: the median over the
window's untraced rest (its last ``window_steps`` steps, none under the
profiler) of the seconds from a step's entry to its return, as the
program's step record (``scan2cap_torch/utils/profiling.STEP_RECORD``)
holds them.  After the window the check runs only the reference, which
adds no entry."""

import statistics


def read(r):
    try:
        from scan2cap_torch.utils.profiling import STEP_RECORD
    except ImportError:
        return None
    if not r.window_steps:
        return None
    last = list(STEP_RECORD)[-r.window_steps:]
    untraced = [e.seconds for e in last if not e.traced]
    return statistics.median(untraced) * 1e3 if untraced else None
