"""The repeat probe: two runs of the program on one seed, and the count
of the calls whose picks part between runs."""

import torch

from h100bench import repeat
from h100bench.tests import tiny

CPU = torch.device("cpu")


def test_parting_counts_calls_and_indices_by_step():
    a = [torch.tensor([0, 1, 2]), torch.tensor([[3, 4]]),
         torch.tensor([0, 1, 2]), torch.tensor([[3, 4]])]
    b = [torch.tensor([0, 1, 2]), torch.tensor([[3, 5]]),
         torch.tensor([0, 2, 1]), torch.tensor([[4, 5]])]
    assert repeat.parting(a, b, 2) == [[1, 1], [2, 4]]
    assert repeat.parting(a, b[:3], 2) == [[-1, -1], [-1, -1]]


def test_recorded_copies_each_result_and_restores():
    class M:
        @staticmethod
        def f(x):
            return x + 1
    out = []
    with repeat.recorded(M, ["f"], out):
        M.f(torch.tensor([1]))
        M.f(torch.tensor([2]))
    assert [int(t) for t in out] == [2, 3]
    assert int(M.f(torch.tensor([0]))) == 1 and len(out) == 2


def test_two_runs_on_the_cpu_agree_with_each_other_and_the_reference():
    r = repeat.repeat(tiny.cell("maskvotenet-train-b16"), 2 ** 31 + 7, CPU)
    assert r["losses"]["a"] == r["losses"]["b"]
    assert all(v == 0 for v in r["b_vs_a"].values()), r["b_vs_a"]
    assert r["picks"]["b_vs_a"] == [[0, 0]] * 3
    assert r["picks"]["a_vs_reference"] == [[0, 0]] * 3
