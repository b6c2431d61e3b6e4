"""The host's ms of one step's Hungarian matching: the median over the
window's untraced rest (its last ``window_steps`` steps) of the program's
matching record (``scan2cap_torch/utils/profiling.MATCH_RECORD``, one
entry a step: cost matrices, the copy that waits for the forward, the
assignments).  After the window the check runs only the reference, which
adds no entry.  A program without the record reads nothing."""

import statistics


def read(r):
    try:
        from scan2cap_torch.utils.profiling import MATCH_RECORD
    except ImportError:
        return None
    if not r.window_steps:
        return None
    last = list(MATCH_RECORD)[-r.window_steps:]
    untraced = [e.seconds for e in last if not e.traced]
    return statistics.median(untraced) * 1e3 if untraced else None
