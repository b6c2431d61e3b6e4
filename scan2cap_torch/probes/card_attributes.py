"""The kernels whose launches set a per-card attribute first, on card 0 and
then on every other card from one process, in the package of any checkout
(``sys.argv[1]``), so that two designs can be run one after the other:
FPS at 100,000 and 200,000 points (B=2, 512 picks: the 16-block register
tier and the shared-state tier, ``csrc/fps.cu``) and both pack-tile probes
(``csrc/pack_probe.cu``), each held against its plain version on the same
card.  Prints one JSON line: per card, "exact", "differs" or the launch's
error.

    python scan2cap_torch/probes/card_attributes.py <checkout>

Needs the cards.  ``scripts/dryrun_multicard.other_cards`` makes the same
launches, and fails on the first that is not exact.
"""
import json
import sys


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from scan2cap_torch.kernels import fps as fk
    from scan2cap_torch.kernels import pack_probe as pk
    from scan2cap_torch.ops import sampling
    from scan2cap_torch.probes import pack, shift

    rows = []
    for card in range(torch.cuda.device_count()):
        dev = torch.device("cuda", card)
        g = torch.Generator().manual_seed(7)
        _, hit, ints = pack.probe_tiles()[1]
        h, i = torch.from_numpy(hit).to(dev), torch.from_numpy(ints).to(dev)
        row = {"card": card}
        for name, run in (
                ("fps_100000", lambda: (
                    fk.furthest_point_sample_cuda(x1, 512),
                    sampling.furthest_point_sample_plain(x1, 512))),
                ("fps_200000", lambda: (
                    fk.furthest_point_sample_cuda(x2, 512),
                    sampling.furthest_point_sample_plain(x2, 512))),
                ("pack_probe", lambda: (pk.pack_probe_cuda(h),
                                        pack.pack_probe_plain(h))),
                ("shift_probe", lambda: (pk.shift_probe_cuda(h, i),
                                         shift.shift_probe_plain(h, i)))):
            x1 = (torch.rand((2, 100000, 3), generator=g) * 8).to(dev)
            x2 = (torch.rand((2, 200000, 3), generator=g) * 8).to(dev)
            try:
                got, want = run()
                torch.cuda.synchronize(dev)
                if torch.is_tensor(got):
                    got, want = (got,), (want,)
                row[name] = "exact" if all(torch.equal(a, b) for a, b in
                                           zip(got, want)) else "differs"
            except RuntimeError as e:
                row[name] = f"error: {e}"[:160]
        rows.append(row)
    print(json.dumps({"root": root, "rows": rows,
                      "current": torch.cuda.current_device()}))


if __name__ == "__main__":
    main(sys.argv[1])
