"""Times the two pack-tile probe kernels in the kernels of any checkout of
this repository, so that two designs can be set side by side on one card,
one after the other in one command.

On the tile of ``chip_smoke.py``'s probe rows (hits at density 0.3 from
seed 5, ints below 65,536): each probe's time on the device from a
profiler trace (all kernels of a call, and the probe kernel alone) and by
CUDA events around back-to-back calls, each result held against the same
checkout's plain version.  Where the checkout's wrapper has it, also the
device time of an empty launch, on one block and on the probes' grid: the
floor under a one-launch kernel of that size.  Each row names the
checkout's ``SPLIT`` (blocks of a cluster that share K): another partition
is timed in a copy whose ``kSplit`` (``csrc/pack_probe.cu``) and ``SPLIT``
(``kernels/pack_probe.py``) are both edited.

Run from any directory:
  python scan2cap_torch/probes/pack_times.py [--root CHECKOUT] [--json PATH]
``--root`` names the checkout whose ``scan2cap_torch`` is timed (default:
the one this file lies in).  Needs the card.  The runner is
``checkout.py``.
"""

from __future__ import annotations

import sys

if __package__:
    from scan2cap_torch.probes import checkout
else:           # run as a file, before --root's package is imported
    import checkout

ITERS = 200


def run():
    import numpy as np
    import torch

    from scan2cap_torch.kernels import pack_probe as wrapper
    from scan2cap_torch.probes import pack, shift
    from scan2cap_torch.probes.timing import event_ms, profile_calls

    dev = torch.device("cuda", torch.cuda.current_device())
    rs = np.random.RandomState(5)
    hit = torch.from_numpy((rs.rand(1, 256, 512) < 0.3).astype(
        np.float32)).to(dev)
    ints = torch.from_numpy(rs.randint(0, 65536, (1, 256, 128)).astype(
        np.int32)).to(dev)
    split = getattr(wrapper, "SPLIT", None)

    def timed(call, kernel):
        """Device ms a call (every kernel, and those whose name holds
        `kernel`), events ms."""
        call()
        r = profile_calls(call, calls=ITERS, complete=lambda rows: any(
            kernel in n and c == ITERS for _, n, c in rows))
        own = [(t, n) for t, n, c in r["rows"] if kernel in n]
        return dict(device_ms=sum(t for t, _, _ in r["rows"]) / ITERS,
                    kernel_device_ms=sum(t for t, _ in own) / ITERS,
                    kernels_per_call=sum(c for _, _, c in r["rows"]) / ITERS,
                    kernel_name=own[0][1][:60] if own else None,
                    complete=r["complete"], ms=event_ms(call, ITERS))

    def pack_call():
        return wrapper.pack_probe_cuda(hit)

    def shift_call():
        return wrapper.shift_probe_cuda(hit, ints)

    rows = []
    for name, call, plain in (
            ("pack_probe", pack_call, lambda: pack.pack_probe_plain(hit)),
            ("shift_probe", shift_call,
             lambda: shift.shift_probe_plain(hit, ints))):
        equal = all(torch.equal(a, b) for a, b in zip(call(), plain()))
        rows.append(dict(kernel=name, split=split, equal=equal,
                         **timed(call, "probe_kernel")))
    if hasattr(wrapper, "empty_launch_cuda"):
        for blocks, cluster in ((1, 1), (wrapper.M_TILES * split, split)):
            def empty():
                wrapper.empty_launch_cuda(dev, blocks, cluster)
            rows.append(dict(kernel="empty", blocks=blocks, cluster=cluster,
                             equal=True, **timed(empty, "probe_empty_kernel")))
    return dict(split=split, iters=ITERS, rows=rows)


def show(r) -> str:
    what = (f"split {r['split']}" if r["kernel"] != "empty"
            else f"{r['blocks']} blocks / {r['cluster']}")
    return (f"{r['kernel']:>12} {what:<16} dev {r['device_ms']:.5f} ms "
            f"(kernel {r['kernel_device_ms']:.5f}, "
            f"{r['kernels_per_call']:.0f} a call)  events {r['ms']:.5f} ms  "
            f"{'equal' if r['equal'] else 'DIFFERS'}")


if __name__ == "__main__":
    sys.exit(checkout.main(__file__, __doc__, run, show))
