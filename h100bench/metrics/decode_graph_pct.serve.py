"""The share of the window's served requests whose scene decode replayed
the top-down decoder's forward CUDA graph: of the last ``window_steps``
entries of the program's record of its graphed decodes
(``scan2cap_torch/utils/profiling.DECODE_GRAPH_RECORD``, one a decode:
``capture``, ``replay`` or ``eager``), the replays, in percent.  A served
request decodes its scenes once and runs no teacher-forced decode; after
the window the check runs only the reference, which adds no entry.  A
program that does not record its scene decodes reads nothing."""


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
