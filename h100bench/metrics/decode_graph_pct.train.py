"""The share of the window's teacher-forced decodes that replayed the
top-down decoder's CUDA graphs: of the last ``window_steps`` entries of
the program's record of those decodes
(``scan2cap_torch/utils/profiling.DECODE_GRAPH_RECORD``, one a decode:
``capture``, ``replay`` or ``eager``), the replays, in percent.  One train
step decodes once; after the window the check runs only the reference,
which adds no entry.  A program without the record reads nothing."""


def read(r):
    try:
        from scan2cap_torch.utils.profiling import DECODE_GRAPH_RECORD
    except ImportError:
        return None
    if not r.window_steps:
        return None
    last = list(DECODE_GRAPH_RECORD)[-r.window_steps:]
    if not last:
        return None
    return 100.0 * sum(e.kind == "replay" for e in last) / len(last)
