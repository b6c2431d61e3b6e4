"""What the ball-query wrappers decide before they launch, and the edge
cases their kernels are held to on the card.  All of this runs on the CPU:
the variant chosen by shape, the split of a chunk's copy by alignment, the
wrappers' errors and allocations, an emulation in numpy of the kernel's
bookkeeping (a tile of queries, ranges of whole words, chunks copied at
their source's offset, per-range hit lists capped at nsample, their
concatenation and padding, the zero row; for the pack entry point the
32-word runs; above nsample 256 the ordered scan: chunks in ascending
order, each warp's words, the prefix over warps, the cut at nsample, the
padding) against the plain versions on every named case, and the plain versions at those shapes
against the jitted JAX op and the Pallas pack kernel in interpret mode, so
that what the card is held against is itself held against JAX.  Indices,
words and counts are compared exactly (tolerance 0).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scan2cap_tpu.ops import grouping as jgrouping
from scan2cap_tpu.ops.pallas.ballquery import ball_query_pack_pallas

from scan2cap_torch.kernels import ballquery as bq
from scan2cap_torch.ops import grouping
from scan2cap_torch.probes import cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "scan2cap_torch", "csrc", "ballquery.cu")
# (N, M, nsample) of the five ball-query sites of one flagship forward
SITES = {"sa1": (40000, 2048, 64), "sa2": (2048, 1024, 32),
         "sa3": (1024, 512, 16), "sa4": (512, 256, 16),
         "vote_aggregation": (1024, 256, 16)}


# --- the variant table -------------------------------------------------------
def test_bq_variant_covers_every_shape_without_a_gap():
    bounds = [b for b, _ in bq._BY_SIZE]
    assert bounds[-1] is None and bounds[:-1] == sorted(bounds[:-1])
    for n in list(range(1, 4200)) + list(range(4200, 400000, 997)):
        for m, nsample in ((1, 1), (37, 16), (2048, 64),
                           (5, bq.BQ_SHARED_NSAMPLE), (5, 1024),
                           (1, 257), (2048, 512), (17, 300)):
            v = bq.bq_variant(n, m, nsample)
            assert 0 <= v < len(bq.VARIANTS)
            assert bq.takes(v, nsample)
            assert bq.shared_bytes(v, nsample) <= bq.MAX_SHARED_BYTES
            # above the ranges' lists the ordered scan, by M alone
            assert bq.is_ordered(v) == bq.ordered_scan(nsample)
            if bq.is_ordered(v):
                assert v == bq.bq_variant(1, m, nsample)
        assert bq.takes(bq.bq_variant(n), 1, pack=True)
    for bound in bounds[:-1]:
        assert bq.bq_variant(bound) != bq.bq_variant(bound + 1)
        assert bq.bq_variant(bound) == bq.bq_variant(bound - 1)
    ordered = [b for b, _ in bq._ORDERED_BY_QUERIES]
    assert ordered[-1] is None and ordered[:-1] == sorted(ordered[:-1])
    for m in range(0, 3000):
        assert bq.is_ordered(bq.bq_variant(40000, m, 512))
    for bound in ordered[:-1]:
        assert bq.bq_variant(9, bound, 512) != bq.bq_variant(9, bound + 1, 512)
    # MaskVoteNet's aggregation: one query a scene, all warps of a block on it
    q, g, r, c = bq.VARIANTS[bq.bq_variant(cases.MVN_VOTES, 1,
                                           cases.MVN_NSAMPLE)]
    assert (q, r) == (1, 0) and g >= 4


@pytest.mark.parametrize("v", range(len(bq.VARIANTS)))
def test_bq_every_variant_fits_the_card(v):
    q, g, r, c = bq.VARIANTS[v]
    assert g * max(r, 1) * 32 <= 1024             # threads of a block
    assert c % 32 == 0 and c >= 32                # a chunk is whole words
    assert (3 * c + 4) % 4 == 0                   # buffers stay 16-byte aligned
    # every variant holds the lists of the largest nsample kept in shared
    # memory, and each nsample of the package's configurations
    for nsample in (16, 32, 64, bq.BQ_SHARED_NSAMPLE):
        assert bq.shared_bytes(v, nsample) <= bq.MAX_SHARED_BYTES
    if r == 0:
        # the ordered scan: kUnroll words a warp, no lists: the same shared
        # memory whatever nsample, and no pack
        words = c // (32 * g)                    # a warp's, one a lane
        assert words * 32 * g == c and words % 4 == 0 and words <= 32
        assert bq.shared_bytes(v, bq.BQ_SHARED_NSAMPLE + 1) == bq.shared_bytes(
            v, 1 << 20) == bq.shared_bytes(v, 1) == 2 * (3 * c + 4) * 4 \
            + q * (2 * g + 1) * 4
        assert bq.takes(v, 1 << 20) and not bq.takes(v, 64, pack=True)
        with pytest.raises(ValueError, match="pack"):
            bq.shared_bytes(v, 64, pack=True)
        names = [f"_ZN50_GLOBAL__N__bq17bq_ordered_kernelILi{q}ELi{g}ELi{c}"
                 f"EEEvPKfS2_iifiPi",
                 f"void (anonymous namespace)::bq_ordered_kernel<{q}, {g}, "
                 f"{c}>(float const*, float const*, int)"]
        for name in names:
            assert bq.kernel_of_name(name) == (v, False), name
        return
    # with ranges: nsample up to the shared lists' limit, and the pack
    assert bq.takes(v, bq.BQ_SHARED_NSAMPLE)
    assert not bq.takes(v, bq.BQ_SHARED_NSAMPLE + 1)
    with pytest.raises(ValueError, match="nsample"):
        bq.shared_bytes(v, bq.BQ_SHARED_NSAMPLE + 1)
    assert bq.shared_bytes(v, bq.BQ_SHARED_NSAMPLE) == \
        r * 2 * (3 * c + 4) * 4 + g * q * r * (bq.BQ_SHARED_NSAMPLE + 1) * 4
    assert bq.shared_bytes(v, 64, pack=True) == r * 2 * (3 * c + 4) * 4
    # the variant is read back from a kernel's name, as the build log
    # (mangled) and a profiler trace (demangled) spell it
    for pack in (False, True):
        mangled = (f"_ZN50_GLOBAL__N__bq9bq_kernelILi{q}ELi{g}ELi{r}ELi{c}"
                   f"ELb{int(pack)}EEEvPKfS2_iifiPiPjS3_")
        plain = (f"void (anonymous namespace)::bq_kernel<{q}, {g}, {r}, {c}, "
                 f"{str(pack).lower()}>(float const*, float const*, int)")
        cast = plain.replace(str(pack).lower(), f"(bool){int(pack)}")
        for name in (mangled, plain, cast):
            assert bq.kernel_of_name(name) == (v, pack), name
    assert bq.kernel_of_name("void fps_kernel<8, 256, 20>(float const*)") is None


@pytest.mark.parametrize("site", sorted(SITES))
def test_bq_main_path_sites_get_their_variant(site):
    n, m, nsample = SITES[site]
    shape = bq.VARIANTS[bq.bq_variant(n, m, nsample)]
    assert shape == ((8, 2, 4, 512) if n > 2048 else (4, 2, 4, 512))
    q, g, r, c = shape
    if site == "sa1":                 # 2 x 2,048 queries: warps for 528 schedulers
        assert 2 * (m // q) * r >= 4 * 132 * 2
    # the source's header names the variants of the main path
    with open(SOURCE) as f:
        header = f.read().split("#include")[0]
    assert "%d x %d x %d x %d" % shape in header


def test_bq_variants_are_the_ones_the_source_builds():
    with open(SOURCE) as f:
        text = f.read()
    built = [(int(a), int(b), int(c), int(d)) if d else (int(a), int(b), 0,
                                                         int(c))
             for a, b, c, d in re.findall(
                 r"BQ_(?:VARIANT|ORDERED)\((\d+), (\d+), (\d+)(?:, (\d+))?\)",
                 text.split("const Variant kVariants[]")[1])]
    assert tuple(built) == bq.VARIANTS
    assert len(set(bq.VARIANTS)) == len(bq.VARIANTS)
    assert f"kMaxSharedBytes = {bq.MAX_SHARED_BYTES}" in text
    for _, shape in bq._BY_SIZE + bq._ORDERED_BY_QUERIES:
        assert shape in bq.VARIANTS
    # the old one-warp-per-query kernels are gone, and so are the hit lists
    # in device memory
    assert "ball_query_kernel" not in text and "hit_word" not in text
    assert "bq_lists_kernel" not in text and "int* lists" not in text


@pytest.mark.parametrize("n,ranges,want", [
    (1, 4, (1, 1)), (31, 2, (1, 1)), (33, 2, (2, 1)), (999, 2, (32, 16)),
    (4096, 4, (128, 32)), (39999, 4, (1250, 313)), (40000, 4, (1250, 313)),
    (40000, 8, (1250, 157)), (2048, 1, (64, 64))])
def test_bq_range_words(n, ranges, want):
    words, per_range = bq.range_words(n, ranges)
    assert (words, per_range) == want
    assert per_range * ranges >= words > per_range * (ranges - 1) - ranges


# --- the copy of a chunk -----------------------------------------------------
@pytest.mark.parametrize("past", [0, 4, 8, 12])
def test_bq_copy_plan_by_alignment(past):
    base = 0x7F0000000000 + past
    for nfloats in list(range(0, 40)) + [1533, 1536, 3 * 512, 3 * 2048, 6143]:
        offset, head, body, tail = bq.copy_plan(base, nfloats)
        assert offset == past // 4
        assert head + 4 * body + tail == nfloats
        assert 0 <= head < 4 and 0 <= tail < 4
        if body:                      # 16-byte copies: aligned on both sides
            assert (base + 4 * head) % 16 == 0
            assert (offset + head) % 4 == 0
        assert offset + nfloats < 3 * -(-nfloats // 3) + 4   # the buffer
    with pytest.raises(ValueError):
        bq.copy_plan(base + 2, 8)


@pytest.mark.parametrize("n,want", [(40000, 16), (39999, 4), (999, 4),
                                    (1000, 16), (2048, 16)])
def test_bq_copy_width_from_n_and_the_pointer(n, want):
    """Scene 1 starts n*12 bytes past scene 0: 16-byte copies all the way
    only if n is a multiple of 4 and the tensor's base is aligned."""
    base = 0x7F0000000000
    for b in (0, 1, 2, 3):
        _, head, body, _ = bq.copy_plan(base + b * n * 12, 3 * 512)
        if want == 16:
            assert head == 0 and body == 384
    heads = {bq.copy_plan(base + b * n * 12, 3 * 512)[1] for b in range(4)}
    assert (heads == {0}) == (want == 16)
    # a view 4 or 8 bytes off moves every scene
    for off in (4, 8):
        assert bq.copy_plan(base + off + n * 12, 3 * 512)[1] == (
            (4 - (off // 4 + 3 * n) % 4) % 4)


# --- the wrappers' errors ----------------------------------------------------
def test_bq_wrapper_errors():
    x = torch.zeros((1, 64, 3))
    q = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        bq.ball_query_cuda(x, q, 0.04, 16)
    with pytest.raises(ValueError, match="CUDA"):
        bq.ball_query_pack_cuda(x, q, 0.04)
    with pytest.raises(ValueError, match="float32"):
        bq.ball_query_cuda(x.double(), q, 0.04, 16)
    with pytest.raises(ValueError, match="float32"):
        bq.ball_query_pack_cuda(x, q[..., :2], 0.04)
    with pytest.raises(ValueError, match="nsample"):
        bq.ball_query_cuda(x, q, 0.04, -1)
    with pytest.raises(ValueError, match="nsample"):
        bq.ball_query_cuda(x, q, 0.04, 0)
    # above the shared lists' limit the ordered scan takes it: only the CPU
    # tensor is refused
    with pytest.raises(ValueError, match="CUDA"):
        bq.ball_query_cuda(x, q, 0.04, bq.BQ_SHARED_NSAMPLE + 1)
    with pytest.raises(ValueError, match="N=0"):
        bq.ball_query_cuda(torch.zeros((1, 0, 3)), q, 0.04, 4)
    with pytest.raises(ValueError, match="no variant"):
        bq.ball_query_cuda(x, q, 0.04, 4, variant=len(bq.VARIANTS))
    # a forced variant must take the call: ranges no nsample above their
    # lists, the ordered scan no pack
    ranged = bq.bq_variant(64, 8, 16)
    ordered = bq.bq_variant(64, 8, 512)
    with pytest.raises(ValueError, match="does not take nsample 257"):
        bq.ball_query_cuda(x, q, 0.04, 257, variant=ranged)
    with pytest.raises(ValueError, match="does not take the pack"):
        bq.ball_query_pack_cuda(x, q, 0.04, variant=ordered)
    with pytest.raises(ValueError, match="CUDA"):
        bq.ball_query_cuda(x, q, 0.04, 16, variant=ordered)
    assert bq.BQ_SHARED_NSAMPLE >= 64
    assert not bq.ordered_scan(bq.BQ_SHARED_NSAMPLE)
    assert bq.ordered_scan(bq.BQ_SHARED_NSAMPLE + 1)
    # the CPU path never reaches the wrapper
    assert grouping.ball_query(x, q, 0.2, 4).shape == (1, 8, 4)


# --- the kernel's bookkeeping, emulated --------------------------------------
def _chunk_lanes(flat, address, ps, pe, C, points):
    """What lane reads of a chunk see: the chunk's floats copied into a
    buffer of 3 C + 4 at the source's offset (head, 16-byte body, tail),
    read as ``points`` points from that offset; past the chunk's end a read
    finds what it finds (NaN here) and tests "no hit" by index."""
    buf = np.full(3 * C + 4, np.nan, np.float32)
    nf = 3 * (pe - ps)
    offset, head, body, tail = bq.copy_plan(address + 12 * ps, nf)
    src = flat[3 * ps:3 * pe]
    buf[offset:offset + head] = src[:head]
    for i in range(body):
        at = head + 4 * i
        assert (address + 12 * ps + 4 * at) % 16 == 0
        assert (offset + at) % 4 == 0
        buf[offset + at:offset + at + 4] = src[at:at + 4]
    at = head + 4 * body
    buf[offset + at:offset + at + tail] = src[at:at + tail]
    lanes = np.zeros((points, 3), np.float32)
    span = min(points * 3, 3 * C + 4 - offset)
    lanes.reshape(-1)[:span] = buf[offset:offset + span]
    inside = np.arange(points) < pe - ps
    assert not np.isnan(lanes[inside]).any()
    return np.nan_to_num(lanes), inside


def _emulated_ordered(xyz, new_xyz, r2, nsample, variant):
    """What bq_ordered_kernel computes for one scene, in numpy: Q queries a
    block; the scene's chunks of C points in ascending order; warp w tests
    its C / (32 G) consecutive words of each chunk, kUnroll at a time, up
    to the scene's end, lane l keeping word l's ballot; one count per
    (query, warp); a hit's rank is the query's running count plus the
    warps before it plus the lower lanes' words (a scan across the warp)
    plus its place in its word; ranks below nsample land in the row, a
    full query tests no more, the block leaves when all are full; the row
    is padded with its first hit (0 without one).  Returns the first-k
    rows, the pairs tested and how often each way of writing the ranks
    ran: a warp with more than 3 WW^2 hits of a query in a chunk (WW
    words a warp) walks its words, any other each lane its own word."""
    Q, G, R, C = bq.VARIANTS[variant]
    U = C // (32 * G)
    assert R == 0 and U * 32 * G == C and U % 4 == 0 and U <= 32
    N, M = xyz.shape[0], new_xyz.shape[0]
    flat = xyz.reshape(-1).numpy()
    tiles = -(-M // Q)
    queries = np.zeros((tiles * Q, 3), np.float32)
    queries[:M] = new_xyz.numpy()
    queries = torch.from_numpy(queries)
    idx = np.full((tiles * Q, nsample), -1, np.int64)
    cnt = np.where(np.arange(tiles * Q) < M, 0, nsample)    # past M: full
    first = np.zeros(tiles * Q, np.int64)
    lower = np.tril(np.ones((32, 32), np.int64), -1)       # [lane, lanes below]
    pairs = 0
    walks = dict(bit=0, word=0)
    for t in range(tiles):
        rows = np.arange(t * Q, t * Q + Q)
        for c in range(-(-N // C)):
            if (cnt[rows] >= nsample).all():
                break                     # the block leaves
            ps, pe = c * C, min(c * C + C, N)
            lanes, inside = _chunk_lanes(flat, xyz.data_ptr(), ps, pe, C, C)
            hit = grouping._hits(torch.from_numpy(lanes), queries[rows],
                                 r2).numpy() & inside[None, :]
            hit[cnt[rows] >= nsample] = False     # a full query hits nothing
            # a warp tests its groups of 4 words up to the scene's end
            first_word = ps + 32 * np.arange(0, C // 32, 4)
            pairs += Q * 128 * int((first_word < pe).sum())
            ballot = hit.reshape(Q, G, U, 32).astype(np.int64)
            pop = ballot.sum((2, 3))                          # [query, warp]
            before = np.cumsum(pop, 1) - pop                  # warps before
            words_before = np.cumsum(ballot.sum(3), 2) - ballot.sum(3)
            rank = (cnt[rows][:, None, None, None] + before[:, :, None, None]
                    + words_before[..., None] + ballot @ lower.T)
            # the scan order's own count of the hits ahead of each point
            flat_rank = cnt[rows][:, None] + np.cumsum(
                hit, 1) - hit
            assert (rank.reshape(Q, C)[hit] == flat_rank[hit]).all()
            j = ps + np.arange(C)
            for k in range(Q):
                keep = hit[k] & (rank[k].reshape(C) < nsample)
                r_k = rank[k].reshape(C)[keep]
                idx[rows[k], r_k] = j[keep]
                first[rows[k]] = j[keep][r_k == 0][0] if (r_k == 0).any() \
                    else first[rows[k]]
            ranked = (pop > 0) & (cnt[rows][:, None] + before < nsample)
            walks["word"] += int((ranked & (pop > 3 * U * U)).sum())
            walks["bit"] += int((ranked & (pop <= 3 * U * U)).sum())
            cnt[rows] += pop.sum(1)
    for i in range(M):
        have = min(cnt[i], nsample)
        assert (idx[i, :have] >= 0).all() and (idx[i, have:] == -1).all()
        idx[i, have:] = first[i] if have > 0 else 0
    return idx[:M].astype(np.int32), pairs, walks


def _emulated(xyz, new_xyz, r2, nsample, variant):
    """What csrc/ballquery.cu computes for one scene, in numpy, from the
    hit tests of the plain version: ``xyz`` is the (N, 3) tensor of the
    scene (its address decides how each chunk is copied).  Returns the
    first-k rows, the pack words and counts, and the pairs tested."""
    Q, G, R, C = bq.VARIANTS[variant]
    tile = G * Q
    N, M = xyz.shape[0], new_xyz.shape[0]
    W, Lw = bq.range_words(N, R)
    L = 32 * Lw
    flat = xyz.reshape(-1).numpy()
    address = xyz.data_ptr()
    tiles = -(-M // tile)
    queries = np.zeros((tiles * tile, 3), np.float32)        # past M: zeros
    queries[:M] = new_xyz.numpy()
    queries = torch.from_numpy(queries)

    lists = [[np.zeros(0, np.int64) for _ in range(R)]
             for _ in range(tiles * tile)]
    words = np.zeros((tiles * tile, W), np.uint32)
    written = np.zeros((tiles * tile, W), np.int32)
    weights = (1 << np.arange(32, dtype=np.uint64))
    pairs = 0
    for r in range(R):
        rs = min(r * L, N)
        re_ = min(rs + L, N)
        run = {}                           # word of the range -> (rows,) words
        for c in range(-(-L // C)):
            ps = rs + c * C
            pe = min(ps + C, re_)
            if pe <= ps:
                continue
            # lane l of step s reads words offset + 3 (32 s + l) + 0..2
            steps = -(-(pe - ps) // 32)
            lanes, inside = _chunk_lanes(flat, address, ps, pe, C, steps * 32)
            hit = grouping._hits(torch.from_numpy(lanes),
                                 queries, r2).numpy() & inside[None, :]
            pairs += hit.shape[0] * steps * 32
            for i in range(tiles * tile):
                cols = ps + np.nonzero(hit[i])[0]
                room = nsample - len(lists[i][r])
                lists[i][r] = np.concatenate([lists[i][r], cols[:max(room, 0)]])
            bits = hit.reshape(hit.shape[0], steps, 32).astype(np.uint64)
            chunk_words = (bits * weights).sum(-1).astype(np.uint32)
            for s in range(steps):
                word = c * (C // 32) + s
                k32 = word & 31
                run[k32] = chunk_words[:, s]
                if k32 == 31 or ps + (s + 1) * 32 >= re_:
                    first = r * Lw + word - k32
                    for lane in range(k32 + 1):
                        words[:, first + lane] = run[lane]
                        written[:, first + lane] += 1
                    run = {}
        assert not run
    assert (written == 1).all()            # every word stored exactly once

    idx = np.full((M, nsample), -1, np.int64)
    for i in range(M):
        counts = [min(len(lists[i][r]), nsample) for r in range(R)]
        row = np.concatenate([lists[i][r][:counts[r]] for r in range(R)])
        first = 0
        for r in reversed(range(R)):
            if counts[r] > 0:
                first = lists[i][r][0]
        row = row[:nsample]
        idx[i, :len(row)] = row
        idx[i, len(row):] = first
    popc = np.array([bin(int(w)).count("1") for w in words[:M].reshape(-1)],
                    np.int32).reshape(M, W)
    return idx.astype(np.int32), words[:M], popc, pairs


def _scene_tensors(name):
    xyz, new_xyz, radius, nsample, variant, offset = cases.bq_edge_case(name)
    view = cases.offset_view(xyz, offset)
    assert view.data_ptr() % 16 == 4 * offset
    return view, torch.from_numpy(new_xyz), radius, nsample, variant


def _check_emulated(name, variant=None):
    """The first-k through ``variant`` (the case's or the wrapper's choice
    when None) and the pack through the variant with ranges the pack gets,
    each emulated, against the plain versions.  An nsample above
    BQ_SHARED_NSAMPLE goes through the ordered scan's emulation."""
    xyz, new_xyz, radius, nsample, forced = _scene_tensors(name)
    N, M = xyz.shape[1], new_xyz.shape[1]
    if variant is None:
        variant = forced if forced is not None else bq.bq_variant(
            N, M, nsample)
    pack_variant = variant if bq.takes(variant, nsample, pack=True) else (
        forced if forced is not None else bq.bq_variant(N, M))
    r2 = grouping.radius_squared(radius)
    want = grouping.ball_query_plain(xyz, new_xyz, radius, nsample).numpy()
    want_words, want_counts = grouping.ball_query_pack_plain(xyz, new_xyz, r2)
    scenes = range(xyz.shape[0]) if xyz.shape[0] <= 3 else (0, xyz.shape[0] - 1)
    for b in scenes:
        if bq.is_ordered(variant):
            idx, _, _ = _emulated_ordered(xyz[b], new_xyz[b], r2, nsample,
                                          variant)
            _, words, counts, _ = _emulated(xyz[b], new_xyz[b], r2, 1,
                                            pack_variant)
        else:
            idx, words, counts, _ = _emulated(xyz[b], new_xyz[b], r2,
                                              nsample, variant)
        np.testing.assert_array_equal(idx, want[b])
        np.testing.assert_array_equal(words, want_words[b].numpy())
        np.testing.assert_array_equal(counts, want_counts[b].numpy())
    return want, want_counts.numpy()


@pytest.mark.parametrize("case", cases.BQ_EDGE_CASES)
def test_bq_kernel_bookkeeping_emulated_matches_plain(case):
    _check_emulated(case)


@pytest.mark.parametrize("v", range(len(bq.VARIANTS)))
def test_bq_every_variant_emulated_matches_plain(v):
    for case in ("many_hits", "n33", "view_off_4_bytes",
                 "nsample_th_hit_starts_a_range"):
        _check_emulated(case, variant=v)


def test_bq_constructed_cases_are_what_their_names_say():
    def rows(name):
        xyz, new_xyz, radius, nsample, variant = _scene_tensors(name)
        r2 = grouping.radius_squared(radius)
        idx = grouping.ball_query_plain(xyz, new_xyz, radius, nsample).numpy()
        total = grouping.ball_query_pack_plain(xyz, new_xyz, r2)[1].sum(-1)
        L = cases.bq_range_points(xyz.shape[1], variant)
        return idx, total.numpy(), nsample, L, xyz.shape[1]

    for tail in ("", "_40000"):
        idx, total, s, L, N = rows("exactly_nsample_hits" + tail)
        assert (total == s).all() and len(set(idx[0, 0])) == s
        idx, total, s, L, N = rows("hits_in_last_range" + tail)
        assert (total > s).all() and idx.min() >= (-(-N // L) - 1) * L
        idx, total, s, L, N = rows("nsample_th_hit_ends_a_range" + tail)
        assert (total > s).all() and (idx[..., -1] == L - 1).all()
        idx, total, s, L, N = rows("nsample_th_hit_starts_a_range" + tail)
        assert (total > s).all() and (idx[..., -1] == L).all()
        assert (idx[..., -2] < L).all()
        idx, total, s, L, N = rows("first_hit_in_later_range" + tail)
        assert (total == 5).all() and (idx[..., 0] == 2 * L + 5).all()
        assert (idx[..., 5:] == 2 * L + 5).all()          # the padding
        assert (idx[..., 4] == N - 1).all()
    idx, total, s, _, _ = rows("no_hits")
    assert (total == 0).all() and (idx == 0).all()
    idx, total, s, _, _ = rows("nsample_limit")
    assert s == bq.BQ_SHARED_NSAMPLE and (total > 4 * s).all()
    for name in ("nsample257", "nsample512", "nsample1024",
                 "nsample512_40000"):          # the ordered scan
        idx, total, s, _, N = rows(name)
        assert bq.ordered_scan(s) and (total < s).any()   # some pad
        assert (total >= s).any() or s > N     # and some fill theirs
    idx, total, s, _, N = rows("mvn_aggregation")       # one query a scene
    assert idx.shape == (16, 1, 512) and bq.ordered_scan(s)
    assert (total < s).any() and (total >= s).any() and (total < N).all()
    for tail in ("", "_m1"):                  # the ordered scan's chunks
        def ordered(kind):
            idx, total, s, _, N = rows("ordered_" + kind + tail)
            C = cases.bq_chunk_points(N, idx.shape[1], s)
            assert bq.ordered_scan(s) and N > 3 * C
            return idx, total, s, C, N
        idx, total, s, C, N = ordered("nsample_th_hit_ends_a_chunk")
        assert (total > s).all() and (idx[..., -1] == 2 * C - 1).all()
        idx, total, s, C, N = ordered("nsample_th_hit_starts_a_chunk")
        assert (total > s).all() and (idx[..., -1] == 2 * C).all()
        assert (idx[..., -2] < 2 * C).all()
        idx, total, s, C, N = ordered("hits_in_last_chunk")
        assert (total < s).all() and idx.min() >= (N - 1) // C * C
        assert (idx[..., total[0, 0]:] == idx[..., :1]).all()   # the padding
        idx, total, s, C, N = ordered("no_hits")
        assert s == 512 and (total[:, ::2] == 0).all()
        assert (idx[:, ::2] == 0).all()
        assert (total[:, 1::2] > s).all() or idx.shape[1] == 1
    # both ways of writing the ranks run: lanes walking their own words at
    # sa1's density, the warp walking its words at the aggregation's
    for name, way in (("nsample512_40000", "bit"), ("mvn_aggregation", "word")):
        xyz, new_xyz, radius, nsample, _ = _scene_tensors(name)
        walks = _emulated_ordered(
            xyz[0], new_xyz[0], grouping.radius_squared(radius), nsample,
            bq.bq_variant(xyz.shape[1], new_xyz.shape[1], nsample))[2]
        assert walks[way] > 0, (name, walks)
    idx, total, s, _, N = rows("nsample_above_n")
    assert s > N and (total <= N).all() and (total > 1).all()
    idx, total, s, _, _ = rows("dense_40000")
    assert (total >= s).mean() > 0.3 and (total < s).any()


def test_bq_edge_case_names_are_complete():
    names = set(cases.BQ_EDGE_CASES)
    assert len(names) == len(cases.BQ_EDGE_CASES)
    assert {"on_radius", "no_hits", "many_hits", "n1", "n31", "n33", "n999",
            "n39999", "m1", "m_ragged", "nsample1", "nsample_above_n",
            "nsample_limit", "batch10_40000", "view_off_4_bytes",
            "view_off_8_bytes"} <= names
    for bound, _ in bq._BY_SIZE[:-1]:
        assert {f"boundary_n{bound + d}" for d in (-1, 0, 1)} <= names
    shapes = [cases.bq_edge_case(n) for n in cases.BQ_EDGE_CASES]
    assert {p.shape[1] for p, *_ in shapes} >= {1, 31, 33, 999, 39999, 40000}
    assert {10, 16} <= {p.shape[0] for p, *_ in shapes}
    assert {o for *_, o in shapes} == {0, 1, 2, 3}
    tiles = {bq.VARIANTS[v][0] * bq.VARIANTS[v][1] for v in
             {bq.bq_variant(1), bq.bq_variant(40000)}}
    assert any(all(q.shape[1] % t for t in tiles) for _, q, *_ in shapes)
    assert {"nsample257", "nsample512", "nsample1024", "nsample257_40000",
            "nsample512_40000", "nsample1024_40000", "mvn_aggregation"} <= names
    assert {f"ordered_{kind}{tail}" for tail in ("", "_m1") for kind in (
        "nsample_th_hit_ends_a_chunk", "nsample_th_hit_starts_a_chunk",
        "hits_in_last_chunk", "no_hits")} <= names
    for p, q, radius, nsample, variant, offset in shapes:
        assert p.dtype == q.dtype == np.float32 and p.shape[0] == q.shape[0]
        assert 1 <= nsample
        assert variant is None or 0 <= variant < len(bq.VARIANTS)


@pytest.mark.parametrize("nsample", [1, 64, bq.BQ_SHARED_NSAMPLE,
                                     bq.BQ_SHARED_NSAMPLE + 1, 512, 1024])
def test_bq_wrapper_allocates_its_output_alone(nsample, monkeypatch):
    """The first-k wrapper allocates idx and nothing else, whatever nsample:
    the ordered scan keeps no hit lists in device memory.  Run with the
    launch and the CUDA check stubbed out, on CPU tensors."""
    allocated, launched = [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        allocated.append(tuple(shape[0] if len(shape) == 1 else shape))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(bq, "_prepare", lambda xyz, new_xyz, s, v, what:
                        bq.bq_variant(xyz.shape[1], new_xyz.shape[1], s))
    monkeypatch.setattr(bq, "_launch", object())
    monkeypatch.setattr(bq._build, "launch",
                        lambda fn, dev, *args: launched.append(args))
    monkeypatch.setattr(bq.torch, "empty", empty)
    x, q = torch.zeros((2, 700, 3)), torch.zeros((2, 9, 3))
    before = (bq.ball_query_cuda.launches, bq.ball_query_cuda.ordered_launches)
    idx = bq.ball_query_cuda(x, q, 0.04, nsample)
    assert allocated == [(2, 9, nsample)] and idx.shape == (2, 9, nsample)
    (args,) = launched
    assert len(args) == 9 and args[-1] == bq.bq_variant(700, 9, nsample)
    assert (bq.ball_query_cuda.launches - before[0],
            bq.ball_query_cuda.ordered_launches - before[1]) == (
                1, int(bq.ordered_scan(nsample)))
    bq.ball_query_cuda.launches, bq.ball_query_cuda.ordered_launches = before


# --- the plain versions at the card's edge shapes, against JAX ---------------
@pytest.mark.parametrize("case", cases.BQ_EDGE_CASES)
def test_bq_plain_at_the_edge_shapes_matches_jax(case):
    xyz, new_xyz, radius, nsample, _, _ = cases.bq_edge_case(case)
    got = grouping.ball_query(torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                              radius, nsample)
    want = np.asarray(jgrouping.ball_query(
        jnp.asarray(xyz), jnp.asarray(new_xyz), radius, nsample))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)       # indices exact


@pytest.mark.parametrize("case", ["on_radius", "n1", "n33", "n999",
                                  "m_ragged", "first_hit_in_later_range",
                                  "on_radius_at_boundaries", "boundary_n2049"])
def test_bq_pack_plain_at_the_edge_shapes_matches_pallas(case):
    xyz, new_xyz, radius, _, _, _ = cases.bq_edge_case(case)
    xyz, new_xyz = xyz[:1], new_xyz[:1]
    r2 = grouping.radius_squared(radius)
    words, counts = grouping.ball_query_pack_plain(
        torch.from_numpy(xyz), torch.from_numpy(new_xyz), r2)
    pw, pc = ball_query_pack_pallas(jnp.asarray(xyz), jnp.asarray(new_xyz), r2,
                                    interpret=True)
    W = -(-xyz.shape[1] // 32)
    np.testing.assert_array_equal(words.numpy(), np.asarray(pw)[..., :W])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(pc)[..., :W])
