"""The probes' plain PyTorch versions against the TPU kernels' own bodies.

The three probe scripts under ``scripts/`` are loaded by path and their
Pallas kernels are run on the CPU in the TPU interpret mode
(``pltpu.force_tpu_interpret_mode``), which accepts the scripts' VMEM and
SMEM block specs as they are: nothing in ``scripts/`` changes.  The gather
script's shape constants are module globals read at trace time, so the test
sets them to a small table before the first call.  Every word and every
gathered row must be equal; the raw float32 product too (0/1 hits times
powers of two: exact in any order).  The CUDA kernels themselves are held
against these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_kernels.py``).
"""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scan2cap_tpu.ops.pallas.ballquery import _MQ, _NC, _pack_matrix

from scan2cap_torch.kernels import pack_probe as kernel_consts
from scan2cap_torch.ops import grouping
from scan2cap_torch.probes import gather as gather_probe
from scan2cap_torch.probes import pack, shift

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hits(kind):
    if kind == "crafted":
        return pack.crafted_hits()
    rs = np.random.RandomState(5)
    if kind == "random":
        return (rs.rand(1, _MQ, _NC) < 0.3).astype(np.float32)
    if kind == "all_ones":
        return np.ones((1, _MQ, _NC), np.float32)
    raise KeyError(kind)


def test_tile_constants_and_pack_matrix_are_the_jax_ones():
    assert (kernel_consts.MQ, kernel_consts.NC) == (_MQ, _NC)
    np.testing.assert_array_equal(pack.pack_matrix().numpy(),
                                  np.asarray(_pack_matrix()))


@pytest.mark.parametrize("kind", ["crafted", "random", "all_ones"])
def test_pack_probe_plain_matches_the_pallas_kernel(kind):
    script = _load("micro_mxu_pack_probe")
    hit = _hits(kind)
    with pltpu.force_tpu_interpret_mode():
        raw, word = (np.asarray(x) for x in script.probe(jnp.asarray(hit)))
    got_raw, got_word = pack.pack_probe(torch.from_numpy(hit))
    assert got_raw.shape == raw.shape == (1, _MQ, 128)
    assert got_word.dtype == torch.int32
    np.testing.assert_array_equal(got_raw.numpy(), raw)
    np.testing.assert_array_equal(got_word.numpy(), word)
    assert not got_raw[..., 48:].any() and not got_word[..., 16:].any()


@pytest.mark.parametrize("kind", ["crafted", "random", "all_ones"])
def test_shift_probe_plain_matches_the_pallas_kernel(kind):
    script = _load("micro_mxu_shift_probe")
    hit = _hits(kind)
    ints = shift.crafted_ints()
    if kind != "crafted":
        ints = np.random.RandomState(6).randint(
            0, 65536, ints.shape).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(x) for x in script.probe(jnp.asarray(hit),
                                                    jnp.asarray(ints))]
    got = shift.shift_probe(torch.from_numpy(hit), torch.from_numpy(ints))
    assert len(got) == len(want) == 6
    for name, g, w in zip(shift.NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("fn", ["vmem_gather", "vmem_gather_vec"])
def test_group_points_plain_matches_the_pallas_gather(fn):
    script = _load("micro_vmem_gather")
    script.N, script.C, script.M, script.S = 96, 8, 4, 16
    script.ROWS, script.BLK = 64, 32
    rs = np.random.RandomState(7)
    table = rs.randn(script.N, script.C).astype(np.float32)
    idx = rs.randint(0, script.N, (script.ROWS,)).astype(np.int32)
    idx[:4] = [0, script.N - 1, 5, 5]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(script, fn)(jnp.asarray(table),
                                              jnp.asarray(idx)))
    got = grouping.group_points(
        torch.from_numpy(table)[None],
        torch.from_numpy(idx).reshape(1, script.M, script.S))
    np.testing.assert_array_equal(got.reshape(script.ROWS, script.C).numpy(),
                                  want)


def test_pack_probe_table_is_all_ok_on_the_plain_path():
    lines, nbad = pack.run("cpu")
    assert nbad == 0 and len(lines) == len(pack.VALS) + 3
    assert all(line.endswith("ok") for line in lines[1:1 + len(pack.VALS)])
    assert pack.main(["--device", "cpu"]) == 0


def test_shift_probe_table_is_all_ok_on_the_plain_path():
    lines, nbad = shift.run("cpu")
    assert nbad == 0 and "NONE" not in lines[-1]
    assert all(n in lines[-1] for n in shift.NAMES)
    assert shift.main(["--device", "cpu"]) == 0


def test_pack_probe_reports_a_wrong_row(monkeypatch):
    # a post-chain that loses the high half-word must fail the run
    def broken(hit):
        raw, word = pack.pack_probe_plain(hit)
        return raw, word & 0xFFFF
    monkeypatch.setattr(pack, "pack_probe", broken)
    lines, nbad = pack.run("cpu")
    assert nbad == len(pack.VALS)
    assert pack.main(["--device", "cpu"]) == 1


def test_production_pack_agrees_with_the_probe_words():
    hit = torch.from_numpy(pack.crafted_hits())
    want = [(v | (v << 16)) & 0xFFFFFFFF for v in pack.VALS]
    assert pack.production_words(hit)[:len(want)].tolist() == want


def test_gather_probe_runs_small_on_the_cpu():
    r = gather_probe.run("cpu", n=128, m=4)
    assert r["equal"] and r["rows"] == 4 * gather_probe.S
    assert "kernel_ms" not in r              # no device time from a CPU run
