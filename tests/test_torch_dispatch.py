"""What the FPS and row-gather wrappers decide before they launch, and the
edge cases their kernels are held to on the card.  All of this runs on
the CPU: the choice of an FPS variant by N, the gather's vector width by
width and alignment, the wrappers' errors, the build log's reading, an
emulation of the FPS kernel's arithmetic (integer keys, points dealt round
over the threads of a cluster of 1, 8 or 16 blocks, register slots before
shared-memory slots, a hierarchical argmax, the winner's coordinates from
its own thread) against the plain version, and the plain version at the
card's edge shapes against the JAX op, so that what the card is held
against is itself held against JAX.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scan2cap_tpu.ops.sampling import _furthest_point_sample_xla

from scan2cap_torch.kernels import _build, fps, gather
from scan2cap_torch.ops import distance, grouping, sampling
from scan2cap_torch.probes import cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the on-chip variants' bounds; the last row of _BY_SIZE takes every N
# above them
BOUNDS = [bound for bound, _ in fps._BY_SIZE if bound is not None]
STREAMED = fps.fps_variant(fps.ON_CHIP_POINTS + 1)
# shared memory a block can use on sm_90, less the kernel's static part
SHARED_BYTES = 232448 - 1024


def _holds(variant):
    """The largest N a variant holds (a streaming one: any)."""
    return fps.variant_points(variant) or float("inf")


@pytest.mark.parametrize("bound", BOUNDS)
def test_fps_variant_holds_every_n_up_to_its_bound(bound):
    lo = ([0] + BOUNDS)[BOUNDS.index(bound)] + 1
    v = fps.fps_variant(bound)
    # every N of the stretch gets the same variant, and it holds them all
    step = max(1, (bound - lo) // 257)
    for n in sorted(set(range(lo, bound + 1, step)) | {lo, bound - 1, bound}):
        if n >= lo:
            assert fps.fps_variant(n) == v, n
            assert _holds(v) >= n
    assert fps.fps_variant(bound + 1) != v
    cluster, threads, points, shared = fps.VARIANTS[v]
    assert cluster * threads * (points + shared) >= bound
    # one block while 2048 points fit its registers, a cluster of 8 above,
    # of 16 above what 8 blocks' registers hold, shared slots above what
    # 16 blocks' registers hold
    assert (cluster == 1) == (bound <= 2048)
    assert (cluster == 16) == (bound > 81920)
    assert (shared > 0) == (bound > fps.REGISTER_POINTS)
    # a thread's state (4 registers a point) leaves 24 of its share of the
    # SM's 65,536 registers to the loop; the register points' copy (16
    # bytes a point, 12 beside shared slots) and the shared slots' state
    # (16 bytes a point) fit a block's shared memory
    assert 4 * points + 24 <= min(255, 65536 // threads)
    copy = 12 if shared else 16
    assert threads * (copy * points + 16 * shared) <= SHARED_BYTES


def test_fps_variant_covers_one_to_the_limit_without_a_gap():
    assert BOUNDS == sorted(BOUNDS)
    assert fps._BY_SIZE[-1][0] is None
    assert fps.ON_CHIP_POINTS == BOUNDS[-1] >= 250000
    assert fps.ON_CHIP_POINTS == max(
        fps.variant_points(v) or 0 for v in range(len(fps.VARIANTS)))
    # registers hold 163,840 points (16 x 256 x 40), and every scene up to
    # there stays in them
    assert fps.REGISTER_POINTS == BOUNDS[-2] == 163840
    assert fps.REGISTER_POINTS == max(
        c * t * p for c, t, p, s in fps.VARIANTS if not s)
    for n in range(1, 4200):
        assert _holds(fps.fps_variant(n)) >= n
    for n in range(4200, fps.ON_CHIP_POINTS + 1, 97):
        v = fps.fps_variant(n)
        assert _holds(v) >= n
        assert fps.tier(v) == ("registers" if n <= 81920 else "cluster16"
                               if n <= fps.REGISTER_POINTS else "shared_state")
    # above what a 16-block cluster holds on chip, every N streams: no
    # limit, no refusal
    assert fps.VARIANTS[STREAMED] == (8, 1024, 0, 0)
    for n in (fps.ON_CHIP_POINTS + 1, 400001, 10 ** 7):
        assert fps.fps_variant(n) == STREAMED
        assert fps.tier(STREAMED) == "streamed"


@pytest.mark.parametrize("n,shape", [(40000, (8, 256, 20, 0)),
                                     (2048, (1, 512, 4, 0)),
                                     (1024, (1, 256, 4, 0)),
                                     (512, (1, 128, 4, 0))])
def test_fps_main_path_sites_get_their_variant(n, shape):
    assert fps.VARIANTS[fps.fps_variant(n)] == shape
    assert fps.tier(fps.fps_variant(n)) == "registers"
    # the source's header names the variants of the main path
    with open(os.path.join(ROOT, "scan2cap_torch", "csrc", "fps.cu")) as f:
        header = f.read().split("#include")[0]
    assert "%d x %d x %d" % shape[:3] in header.replace(",", "")


def test_fps_variants_are_the_ones_the_source_builds():
    with open(os.path.join(ROOT, "scan2cap_torch", "csrc", "fps.cu")) as f:
        text = f.read()
    built = re.findall(r"FPS_VARIANT\((\d+), (\d+), (\d+), (\d+)\)", text)
    assert tuple(tuple(int(x) for x in v) for v in built) == fps.VARIANTS
    assert len(set(fps.VARIANTS)) == len(fps.VARIANTS)
    for cluster, threads, points, shared in fps.VARIANTS:
        assert cluster in (1, 8, 16) and threads % 32 == 0 and threads <= 1024
        # shared slots only beside full register slots of a cluster
        assert not shared or (cluster == 16 and points > 0)
    # the variants without a limit stream through a cluster
    assert [v for v in fps.VARIANTS if v[2] == 0] == [(8, 1024, 0, 0),
                                                     (16, 1024, 0, 0)]
    # a cluster of 16 is non-portable: the source allows it and asks the
    # card whether it can place one
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in text
    assert "cudaOccupancyMaxActiveClusters" in text


@pytest.mark.parametrize("n,npoint,match", [
    (0, 4, "outside"), (fps.REGISTER_POINTS + 1, 4, "CUDA tensor"),
    (64, 0, "positive"), (64, -3, "positive"), (64, 4, "CUDA tensor")])
def test_fps_wrapper_errors(n, npoint, match):
    with pytest.raises(ValueError, match=match):
        fps.furthest_point_sample_cuda(torch.zeros((1, n, 3)), npoint)


def test_fps_wrapper_refuses_a_variant_too_small():
    with pytest.raises(ValueError, match="does not hold"):
        fps.furthest_point_sample_cuda(torch.zeros((1, 4000, 3)), 4,
                                       variant=fps.fps_variant(512))
    with pytest.raises(ValueError):
        fps.fps_variant(0)
    with pytest.raises(ValueError):
        fps.fps_variant(-1)
    # the streaming variant holds any N: only the CPU tensor is refused
    with pytest.raises(ValueError, match="CUDA tensor"):
        fps.furthest_point_sample_cuda(torch.zeros((1, 4000, 3)), 4,
                                       variant=STREAMED)


@pytest.mark.parametrize("out_off", [0, 4, 8, 12])
@pytest.mark.parametrize("feat_off", [0, 4, 8, 12])
def test_gather_vector_width(feat_off, out_off):
    base = 0x7F0000000000
    for C in range(1, 141):
        v = gather.gather_vector_bytes(C, base + feat_off, base + out_off)
        assert v in (4, 8, 16)
        assert (4 * C) % v == 0
        assert (base + feat_off) % v == 0 and (base + out_off) % v == 0
        # and no wider vector would do
        for wider in (8, 16):
            if wider > v:
                assert ((4 * C) % wider or feat_off % wider or out_off % wider)


@pytest.mark.parametrize("C,want", [(64, 16), (128, 16), (138, 8), (130, 8),
                                    (3, 4), (1, 4), (2, 8), (6, 8)])
def test_gather_vector_width_at_the_model_widths(C, want):
    assert gather.gather_vector_bytes(C, 512, 1024) == want


def test_gather_wrapper_errors():
    x = torch.zeros((1, 8, 4))
    idx = torch.zeros((1, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gather.group_points_cuda(x, idx)


def test_build_log_reading():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z10fps_kernelILi8ELi1024E"
        "Li5EEvPKfiiPi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z10fps_kernelILi8ELi1024ELi5"
        "EEvPKfiiPi\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 1024 bytes smem, 384 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z6gatherIfLi4EEvPKT_' for "
        "'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 18 registers, 400 bytes cmem[0]\n")
    got = _build.kernel_resources(log)
    assert [k["registers"] for k in got] == [40, 18]
    assert [k["smem"] for k in got] == [1024, 0]
    assert got[0]["spill_stores"] == 0 and got[1]["spill_loads"] == 12
    assert "fps_kernel" in got[0]["name"]
    assert _build.kernel_resources("") == []


# --- the FPS kernel's arithmetic, emulated ---------------------------------
def _fps_emulated(xyz, npoint, variant):
    """What csrc/fps.cu computes for one scene, in numpy: running mins as
    the int32 bit patterns of the distances (-1 for padding, -2 for a slot
    beyond N), point j in slot j // (CS*T) of thread j % (CS*T), slots
    0..P-1 in registers and then as many shared slots as N needs (at most
    S), scanned in that order; the argmax taken per thread, warp, block and
    cluster, each level by (largest key, then smallest index); the winner's
    coordinates from its own block: a register slot's from the block's copy
    of its register points, a shared slot's from its state in shared
    memory, a streamed point's from the input."""
    cluster, threads, points, shared = fps.VARIANTS[variant]
    tt = cluster * threads
    n = xyz.shape[0]
    need = -(-n // tt)
    if points == 0:
        # a streaming variant: the same deal of points over threads, as
        # many slots as N needs (an absent slot never wins, as -2 does not)
        points, used = need, 0
    else:
        used = max(need - points, 0) if shared else 0
        assert used <= shared and n <= tt * (points + used)
    slots = points + used
    x = torch.from_numpy(xyz)
    pad = np.zeros((tt * slots, 3), np.float32)
    pad[:n] = xyz
    n2 = distance.sq_dist_reduce(x[:, 0], x[:, 1], x[:, 2]).numpy()
    key = np.full(tt * slots, -2, np.int32)
    key[:n] = np.where(n2 > np.float32(1e-3),
                       np.float32(1e10).view(np.int32), np.int32(-1))
    key = key.reshape(slots, tt)                      # [slot, thread]
    # where each block finds its points' coordinates: the copy of the
    # register slots and the shared slots, [slot, thread]
    registers = pad[:points * tt].reshape(points, tt, 3)
    in_shared = pad[points * tt:].reshape(used, tt, 3)
    allp = torch.from_numpy(pad)
    out = np.zeros(npoint, np.int32)
    last = 0

    def arg_max(keys, idxs, groups):
        """(key, idx) argmax inside each of `groups` equal runs."""
        k = keys.reshape(groups, -1)
        i = idxs.reshape(groups, -1)
        top = k.max(1, keepdims=True)
        pick = np.where(k == top, i, np.iinfo(np.int32).max).min(1)
        return top[:, 0], pick

    for step in range(1, npoint):
        d = allp - allp[last]
        d2 = distance.sq_dist_reduce(d[:, 0], d[:, 1], d[:, 2]).numpy()
        assert (d2.view(np.int32) >= 0).all()               # +0 or above
        key = np.minimum(key, d2.view(np.int32).reshape(slots, tt))
        # per thread: register slots, then shared slots, ascending; strict
        # '>' keeps the lowest index
        best = np.full(tt, np.iinfo(np.int32).min, np.int32)
        slot = np.zeros(tt, np.int64)
        for s in range(slots):
            better = key[s] > best
            best = np.where(better, key[s], best)
            slot = np.where(better, s, slot)
        pick = slot * tt + np.arange(tt)
        k, i = arg_max(best, pick, tt // 32)                 # warps
        k, i = arg_max(k, i, cluster)                        # blocks
        assert ((i % tt) // threads == np.arange(cluster)).all()   # its own
        # each block's candidate travels with its coordinates
        at, owner = i // tt, i % tt
        coords = np.where((at < points)[:, None],
                          registers[np.minimum(at, points - 1), owner],
                          in_shared[np.maximum(at - points, 0), owner]
                          if used else 0.0)
        k, i = arg_max(k, i, 1)                              # the cluster
        last = int(i[0])
        assert last < n
        np.testing.assert_array_equal(coords[last % tt // threads], xyz[last])
        out[step] = last
    return out


@pytest.mark.parametrize("case,variant", [
    ("padding", None), ("all_invalid", None), ("ties", None),
    ("ties", (8, 256, 4, 0)), ("n1", None), ("n1", (8, 256, 4, 0)),
    ("n5", (8, 256, 4, 0)), ("n9", (8, 256, 4, 0)), ("n9", (1, 32, 16, 0)),
    ("boundary_n513", None), ("boundary_n2049", None),
    ("padding", (8, 128, 40, 0)), ("padding", (8, 1024, 0, 0)),
    ("ties", (8, 1024, 0, 0)), ("n1", (8, 1024, 0, 0)),
    ("n9", (8, 1024, 0, 0)), ("all_invalid", (8, 1024, 0, 0)),
    ("mvn_aggregation", None),
    # a cluster of 16 blocks, registers only
    ("ties", (16, 256, 28, 0)), ("n1", (16, 256, 24, 0)),
    ("n9", (16, 256, 40, 0)), ("padding", (16, 256, 32, 0)),
    ("all_invalid", (16, 256, 36, 0)), ("ties", (16, 512, 20, 0)),
    # the shared-state tier, forced onto small scenes (its register slots)
    # and at its own sizes (the second copy of each point and the last
    # points in shared slots)
    ("ties", (16, 256, 40, 26)), ("n1", (16, 256, 40, 26)),
    ("n9", (16, 512, 20, 13)), ("padding", (16, 256, 40, 26)),
    ("all_invalid", (16, 512, 20, 13)), ("boundary_n163841", None),
    ("ties_across_slots_200000", None),
    ("boundary_n163841", (16, 512, 20, 13)),
    # streamed through 16 blocks
    ("padding", (16, 1024, 0, 0)), ("ties", (16, 1024, 0, 0))])
def test_fps_kernel_arithmetic_emulated_matches_plain(case, variant):
    xyz, npoint, _ = cases.fps_edge_case(case)
    npoint = min(npoint, 24)
    v = (fps.fps_variant(xyz.shape[1]) if variant is None
         else fps.VARIANTS.index(variant))
    assert _holds(v) >= xyz.shape[1]
    want = sampling.furthest_point_sample_plain(
        torch.from_numpy(xyz), npoint).numpy()
    for b in range(xyz.shape[0]):
        np.testing.assert_array_equal(
            _fps_emulated(xyz[b], npoint, v), want[b])


# --- the plain versions at the card's edge shapes, against JAX -------------
def _small(name):
    """The card's large edge cases at a size the CPU takes in a moment."""
    rs = np.random.RandomState(17)
    if name == "ties_across_halves":
        x = np.round(rs.randn(2, 1200, 3) * 2.0).astype(np.float32) / 2.0
        x[:, 600:] = x[:, :600]
        return x, 96
    if name == "padding_tail":
        x = rs.randn(2, 1200, 3).astype(np.float32) + 3.0
        x[:, 300:] = 0.0
        return x, 64
    if name == "all_invalid":
        x = rs.randn(2, 1200, 3).astype(np.float32) + 3.0
        x[1] = 0.0
        return x, 32
    raise KeyError(name)


@pytest.mark.parametrize("case", ["ties_across_halves", "padding_tail",
                                  "all_invalid", "n1", "n5", "n9", "ties",
                                  "padding", "boundary_n511", "boundary_n512",
                                  "boundary_n513", "boundary_n1025",
                                  "mvn_aggregation", "boundary_n81921"])
def test_fps_plain_at_the_edge_shapes_matches_jax(case):
    if case in cases.FPS_EDGE_CASES:
        xyz, npoint, _ = cases.fps_edge_case(case)
    else:
        xyz, npoint = _small(case)
    got = sampling.furthest_point_sample_plain(torch.from_numpy(xyz), npoint)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)      # indices exact
    if case == "padding_tail":
        assert got.max() < 300
    if case == "all_invalid":
        assert (got[1] == 0).all()


@pytest.mark.parametrize("case", sorted(cases.GATHER_EDGE_CASES))
def test_gather_plain_at_the_edge_shapes_matches_jax(case):
    from scan2cap_tpu.ops import grouping as jgrouping
    shape = cases.GATHER_EDGE_CASES[case]
    flat, idx, offset = cases.gather_edge_case(case)
    table = cases.gather_table(flat, shape[:3], offset)
    view = cases.gather_table(torch.from_numpy(flat), shape[:3], offset)
    assert view.is_contiguous() and view.storage_offset() == offset
    got = grouping.group_points(view, torch.from_numpy(idx)).numpy()
    want = np.asarray(jgrouping.group_points(jnp.asarray(table),
                                             jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)              # exact copies


def test_edge_case_names_are_complete():
    for bound in BOUNDS:
        assert f"boundary_n{bound}" in cases.FPS_EDGE_CASES
        assert f"boundary_n{bound + 1}" in cases.FPS_EDGE_CASES
    for name, where in (("large_n81921", "cluster16"),
                        ("large_n100000", "cluster16"),
                        ("large_n150000", "cluster16"),
                        ("large_n200000", "shared_state")):
        xyz, npoint, variant = cases.fps_edge_case(name)
        assert xyz.shape[:2] == (2, int(name[len("large_n"):]))
        assert npoint == 2048 and fps.tier(fps.fps_variant(xyz.shape[1])) == where
    for forced, where in (("_in_16_blocks", "cluster16"),
                          ("_in_shared_state", "shared_state"),
                          ("_streamed", "streamed")):
        held = [cases.fps_edge_case(n)[2] for n in cases.FPS_EDGE_CASES
                if n.endswith(forced)]
        assert len(held) >= 4 and {fps.tier(v) for v in held} == {where}
    # ties and padding across 16 blocks, more clusters than the card
    # places at once, and ties between register and shared slots
    for name, n, B in (("ties_across_blocks_100000", 100000, 2),
                       ("padding_70000_of_100000", 100000, 2),
                       ("batch10_100000", 100000, 10),
                       ("ties_across_slots_200000", 200000, 2)):
        xyz, npoint, variant = cases.fps_edge_case(name)
        assert xyz.shape[:2] == (B, n) and variant is None
    xyz = cases.fps_edge_case("ties_across_slots_200000")[0]
    assert (xyz[:, 100000:] == xyz[:, :100000]).all()
    assert 100000 < fps.REGISTER_POINTS < 200000     # copies in shared slots
    for name in cases.FPS_EDGE_CASES:
        xyz, npoint, variant = cases.fps_edge_case(name)
        assert xyz.dtype == np.float32 and xyz.shape[-1] == 3 and npoint >= 1
        held = variant if variant is not None else fps.fps_variant(xyz.shape[1])
        assert _holds(held) >= xyz.shape[1]
    widths = {shape[2] for shape in cases.GATHER_EDGE_CASES.values()}
    assert {1, 2, 3, 6, 130, 138} <= widths
    offsets = {shape[5] for shape in cases.GATHER_EDGE_CASES.values()}
    assert {0, 1, 2} <= offsets
