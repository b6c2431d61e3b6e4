"""Attention kernels: the profiled steps' summed bound over their summed
device time, in percent.  The bound comes from the program's record of
its attention calls (``scan2cap_torch/utils/profiling.ATTENTION_RECORD``,
filled only while a profiler runs, so only by the profiled steps) through
``h100bench/work/attention.py``; the kernels are the trace's
scaled-dot-product-attention kernels.  A program without the record reads
nothing."""

from h100bench.work import attention, share_pct


def read(r):
    try:
        from scan2cap_torch.utils.profiling import ATTENTION_RECORD
    except ImportError:
        return None
    if not ATTENTION_RECORD:
        return None
    return share_pct(r, attention.KERNELS,
                     attention.record_bound_s(ATTENTION_RECORD))
