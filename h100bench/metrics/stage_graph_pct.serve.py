"""The share of the window's untraced stage calls that replayed their CUDA
graph segments: of the program's record of its graphed stages
(``scan2cap_torch/utils/profiling.STAGE_GRAPH_RECORD``, one entry a call
of a model stage or of the eval step's detection loss: ``capture``,
``replay`` or ``eager``), the entries of the last ``window_steps``
requests, each request one call of every stage that the record names,
the replays, in percent.  After the window the check runs only the
reference, which adds no entry.  A program that does not record its
stages reads nothing."""


def read(r):
    try:
        from scan2cap_torch.utils.profiling import STAGE_GRAPH_RECORD
    except ImportError:
        return None
    record = list(STAGE_GRAPH_RECORD)
    stages = len({e.stage for e in record})
    if not r.window_steps or not stages:
        return None
    last = record[-r.window_steps * stages:]
    return 100.0 * sum(e.kind == "replay" for e in last) / len(last)
