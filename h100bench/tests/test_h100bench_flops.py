"""``flops.py``'s count equals what ``FlopCounterMode`` counts on the
reference, for the eval forward and the train steps (forward and
backward) of both configurations at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import flops, kinds, weights
from h100bench.reference.step import eval_forced
from h100bench.tests import tiny


@pytest.mark.parametrize("cell", ["flagship-serve-b8", "flagship-train-b16",
                                  "maskvotenet-train-b16"])
def test_count_equals_flop_counter(cell):
    c = tiny.cell(cell)
    cfg, traffic = c.config, c.traffic
    kind = kinds.of(cfg)
    ref = kind.reference(cfg)
    ref.load_state_dict(weights.make(cfg, 5, "cpu"))
    batch = kind.batches(7, cfg, traffic, "cpu")[0]
    counter = FlopCounterMode(display=False)
    with counter:
        if traffic["path"] == "serve":
            tokens = torch.zeros((traffic["batch"], cfg["num_proposals"],
                                  cfg["max_des_len"] - 1), dtype=torch.int32)
            eval_forced(ref, batch, tokens, tokens)
        else:
            kind.reference_loss(ref, batch, 0.1).backward()
    assert flops.per_step(cfg, traffic) == counter.get_total_flops()
