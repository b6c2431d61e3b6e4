"""The hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc (the kernels are built from
``scan2cap_torch/csrc`` at first use).  Without a card they skip; on the
card run them with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q``
(the conftest sets up JAX, which the card's machine need not have).
Indices, words and counts must be equal.  ``chip_smoke.py`` makes the
same comparison at the full main-path shapes.
"""

import numpy as np
import pytest
import torch

from scan2cap_torch import kernels
from scan2cap_torch.kernels import ballquery as bq_wrapper
from scan2cap_torch.kernels import fps as fps_wrapper
from scan2cap_torch.kernels.gather import gather_vector_bytes
from scan2cap_torch.ops import grouping, sampling
from scan2cap_torch.probes import cases

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fps_case(name):
    rs = np.random.RandomState(3)
    if name == "random":
        return rs.randn(2, 3000, 3).astype(np.float32), 128
    if name == "padding":
        x = rs.randn(2, 1300, 3).astype(np.float32) + 3.0
        x[:, 700:] = 0.0
        return x, 64
    if name == "all_invalid":
        x = rs.randn(2, 400, 3).astype(np.float32) + 2.0
        x[1] = 0.0
        return x, 16
    if name == "ties":
        x = np.round(rs.randn(3, 700, 3) * 2.0).astype(np.float32) / 2.0
        x[:, 350:] = x[:, :350]
        return x, 48
    if name == "batch10":
        return rs.randn(10, 1100, 3).astype(np.float32), 48
    if name == "one_point":
        return rs.randn(2, 1, 3).astype(np.float32) + 1.0, 4
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random", "padding", "all_invalid", "ties",
                                  "batch10", "one_point"])
def test_fps_kernel_matches_plain(card, case):
    x, npoint = _fps_case(case)
    xt = torch.from_numpy(x).to(card)
    before = kernels.furthest_point_sample_cuda.launches
    got = sampling.furthest_point_sample(xt, npoint)
    assert kernels.furthest_point_sample_cuda.launches == before + 1
    want = sampling.furthest_point_sample_plain(xt, npoint)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", cases.FPS_EDGE_CASES)
def test_fps_kernel_edge_cases_match_plain(card, case):
    """Every boundary between the kernel's variants, scenes smaller than a
    cluster, ties and padding across the blocks of a cluster, ten clusters
    in flight, the largest scene: indices exact."""
    x, npoint, variant = cases.fps_edge_case(case)
    xt = torch.from_numpy(x).to(card)
    before = kernels.furthest_point_sample_cuda.launches
    got = kernels.furthest_point_sample_cuda(xt, npoint, variant=variant)
    assert kernels.furthest_point_sample_cuda.launches == before + 1
    want = sampling.furthest_point_sample_plain(xt, npoint)
    assert torch.equal(got, want)
    if case.startswith("all_invalid"):
        assert (got[1] == 0).all()


def test_fps_every_variant_gives_the_same_indices(card):
    x, npoint, _ = cases.fps_edge_case("ties")
    xt = torch.from_numpy(x).to(card)
    want = sampling.furthest_point_sample_plain(xt, npoint)
    for v in range(len(fps_wrapper.VARIANTS)):
        if (fps_wrapper.variant_points(v) or x.shape[1]) >= x.shape[1]:
            got = kernels.furthest_point_sample_cuda(xt, npoint, variant=v)
            assert torch.equal(got, want), fps_wrapper.VARIANTS[v]


def test_fps_streams_a_scene_above_the_register_limit(card):
    """Above what 8 blocks' registers hold a 16-block cluster, above what
    16 blocks' registers hold the shared-state tier, above what it holds
    on chip the scene streams: each launch counted by its tier."""
    for n, where in ((81921, "cluster16"),
                     (fps_wrapper.REGISTER_POINTS + 1, "shared_state"),
                     (fps_wrapper.ON_CHIP_POINTS + 1, "streamed")):
        x = torch.randn((1, n, 3), device=card)
        before = kernels.launch_counts()
        got = sampling.furthest_point_sample(x, 64)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {
                    "furthest_point_sample_cuda": 1, f"fps_{where}": 1}
        assert torch.equal(got, sampling.furthest_point_sample_plain(x, 64))
    with pytest.raises(ValueError):
        kernels.furthest_point_sample_cuda(
            torch.zeros((1, 0, 3), device=card), 4)
    with pytest.raises(ValueError):
        kernels.furthest_point_sample_cuda(
            torch.zeros((1, 64, 3), device=card), 0)


def _bq_case(name, card):
    """A named ball-query case on the card: (xyz, new_xyz, radius, nsample,
    variant); the scene tensor lies where the case says it must."""
    p, q, radius, nsample, variant, offset = cases.bq_edge_case(name)
    pt = cases.offset_view(p, offset, card)
    assert pt.data_ptr() % 16 == 4 * offset
    return pt, torch.from_numpy(q).to(card), radius, nsample, variant


@pytest.mark.parametrize("case", ["on_radius", "no_hits", "many_hits"])
def test_ball_query_kernel_matches_plain(card, case):
    pt, qt, radius, nsample, _ = _bq_case(case, card)
    before = kernels.ball_query_cuda.launches
    got = grouping.ball_query(pt, qt, radius, nsample)
    assert kernels.ball_query_cuda.launches == before + 1
    assert torch.equal(got, grouping.ball_query_plain(pt, qt, radius, nsample))


@pytest.mark.parametrize("case", ["on_radius", "no_hits", "many_hits"])
def test_ball_query_pack_kernel_matches_plain(card, case):
    pt, qt, radius, _, _ = _bq_case(case, card)
    r2 = grouping.radius_squared(radius)
    before = kernels.ball_query_pack_cuda.launches
    words, counts = kernels.ball_query_pack_cuda(pt, qt, r2)
    assert kernels.ball_query_pack_cuda.launches == before + 1
    pw, pc = grouping.ball_query_pack_plain(pt, qt, r2)
    assert words.shape == (pt.shape[0], qt.shape[1], -(-pt.shape[1] // 32))
    assert torch.equal(words.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(counts, pc)


@pytest.mark.parametrize("case", cases.BQ_EDGE_CASES)
def test_ball_query_kernel_edge_cases_match_plain(card, case):
    """Every boundary between the kernel's variants, scenes that are no
    multiple of a word, of 4 points or of a chunk, the nsample-th hit at the
    end of a range and at the start of the next, padding from a later
    range, points on the radius at range and chunk ends, the largest
    nsample, ten scenes of 40,000 points, views off a 16-byte boundary:
    indices exact."""
    pt, qt, radius, nsample, variant = _bq_case(case, card)
    before = kernels.ball_query_cuda.launches
    got = kernels.ball_query_cuda(pt, qt, grouping.radius_squared(radius),
                                  nsample, variant=variant)
    assert kernels.ball_query_cuda.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, grouping.ball_query_plain(pt, qt, radius, nsample))
    if case == "no_hits":
        assert (got == 0).all()


@pytest.mark.parametrize("case", cases.BQ_EDGE_CASES)
def test_ball_query_pack_kernel_edge_cases_match_plain(card, case):
    pt, qt, radius, _, variant = _bq_case(case, card)
    r2 = grouping.radius_squared(radius)
    before = kernels.ball_query_pack_cuda.launches
    words, counts = kernels.ball_query_pack_cuda(pt, qt, r2, variant=variant)
    assert kernels.ball_query_pack_cuda.launches == before + 1
    pw, pc = grouping.ball_query_pack_plain(pt, qt, r2)
    assert torch.equal(words.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(counts, pc)


@pytest.mark.parametrize("case", ["many_hits", "n39999", "m_ragged_split",
                                  "nsample_th_hit_starts_a_range",
                                  "view_off_8_bytes", "nsample_limit",
                                  "nsample512"])
def test_ball_query_every_variant_gives_the_same_indices(card, case):
    pt, qt, radius, nsample, _ = _bq_case(case, card)
    r2 = grouping.radius_squared(radius)
    want = grouping.ball_query_plain(pt, qt, radius, nsample)
    pw, pc = grouping.ball_query_pack_plain(pt, qt, r2)
    for v, shape in enumerate(bq_wrapper.VARIANTS):
        if bq_wrapper.takes(v, nsample):
            got = kernels.ball_query_cuda(pt, qt, r2, nsample, variant=v)
            assert torch.equal(got, want), shape
        if bq_wrapper.takes(v, nsample, pack=True):
            words, counts = kernels.ball_query_pack_cuda(pt, qt, r2, variant=v)
            assert torch.equal(words.view(torch.int32),
                               pw.view(torch.int32)), shape
            assert torch.equal(counts, pc), shape


def test_ball_query_lists_go_to_memory_above_the_shared_limit(card):
    """Above the ranges' shared lists the ordered scan takes the first-k,
    and no call allocates more than its output."""
    x = torch.zeros((1, 64, 3), device=card)
    with pytest.raises(ValueError):
        kernels.ball_query_cuda(x, x, 0.04, 0)
    for nsample in (bq_wrapper.BQ_SHARED_NSAMPLE,
                    bq_wrapper.BQ_SHARED_NSAMPLE + 1, 1024):
        before = kernels.ball_query_cuda.ordered_launches
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        got = kernels.ball_query_cuda(x, x, 0.04, nsample)
        assert torch.cuda.memory_allocated() - held == -(-got.numel() * 4
                                                         // 512) * 512
        assert (kernels.ball_query_cuda.ordered_launches - before
                == int(bq_wrapper.ordered_scan(nsample)))
        assert got.shape == (1, 64, nsample)
        assert (got[0, :, :64] == torch.arange(64, device=card)).all()
        assert (got[0, :, 64:] == 0).all()          # padding: the first hit


def test_wrappers_check_their_inputs(card):
    x = torch.zeros((1, 64, 3), device=card)
    with pytest.raises(ValueError):
        kernels.furthest_point_sample_cuda(x.double(), 4)
    with pytest.raises(ValueError):
        kernels.furthest_point_sample_cuda(
            torch.zeros((1, 3, 64), device=card).transpose(1, 2), 4)
    with pytest.raises(ValueError):
        kernels.ball_query_cuda(x, x[..., :2].contiguous(), 0.1, 4)


def _gather_case(name):
    rs = np.random.RandomState(13)
    if name == "sa1_width":
        B, N, C, M, S = 2, 5000, 64, 256, 64
    elif name == "backward_width":            # C = 138: not a multiple of 4
        B, N, C, M, S = 2, 3000, 138, 128, 64
    elif name == "xyz":
        B, N, C, M, S = 2, 3000, 3, 128, 16
    elif name == "batch10":
        B, N, C, M, S = 10, 700, 256, 64, 16
    elif name == "one_row":
        B, N, C, M, S = 1, 1, 5, 3, 4
    else:
        raise KeyError(name)
    feats = rs.randn(B, N, C).astype(np.float32)
    idx = rs.randint(0, N, (B, M, S)).astype(np.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]        # repeated indices
    idx[:, 0, 0], idx[:, 0, 1 % S] = 0, N - 1
    return feats, idx


@pytest.mark.parametrize("case", ["sa1_width", "backward_width", "xyz",
                                  "batch10", "one_row"])
def test_gather_kernel_matches_plain(card, case):
    feats, idx = _gather_case(case)
    ft, it = torch.from_numpy(feats).to(card), torch.from_numpy(idx).to(card)
    before = kernels.group_points_cuda.launches
    got = grouping.group_points(ft, it)
    assert kernels.group_points_cuda.launches == before + 1
    assert torch.equal(got, grouping.group_points_plain(ft, it))


@pytest.mark.parametrize("case", sorted(cases.GATHER_EDGE_CASES))
def test_gather_kernel_edge_cases_match_plain(card, case):
    """Odd and even widths, table views 4 and 8 bytes off a 16-byte
    boundary, a row count no block divides, ten scenes: exact copies."""
    shape = cases.GATHER_EDGE_CASES[case]
    flat, idx, offset = cases.gather_edge_case(case)
    ft = cases.gather_table(torch.from_numpy(flat).to(card), shape[:3], offset)
    it = torch.from_numpy(idx).to(card)
    assert ft.is_contiguous() and ft.data_ptr() % 16 == (4 * offset) % 16
    got = kernels.group_points_cuda(ft, it)
    assert torch.equal(got, grouping.group_points_plain(ft, it))
    vec = gather_vector_bytes(shape[2], ft.data_ptr(), got.data_ptr())
    assert ft.data_ptr() % vec == 0 and (4 * shape[2]) % vec == 0


def test_gather_gradient_on_the_card(card):
    # the backward is an atomic scatter-add: close, not bit-equal
    feats, idx = _gather_case("sa1_width")
    ft = torch.from_numpy(feats).to(card).requires_grad_(True)
    it = torch.from_numpy(idx).to(card)
    g = torch.randn((2, 256, 64, 64), device=card)
    (grouping.group_points(ft, it) * g).sum().backward()
    f2 = torch.from_numpy(feats).to(card).requires_grad_(True)
    (grouping.group_points_plain(f2, it) * g).sum().backward()
    assert torch.allclose(ft.grad, f2.grad, rtol=1e-5, atol=1e-5)


def test_leaf_projection_uses_the_kernel_twice(card):
    from scan2cap_torch.models.backbone import leaf_gathered_projection
    feats, idx = _gather_case("sa1_width")
    cat = torch.from_numpy(feats).to(card)
    ct_in = torch.randn((2, 256, 64), device=card)
    w0 = torch.randn((64, 32), device=card, requires_grad=True)
    before = kernels.group_points_cuda.launches
    out = leaf_gathered_projection(cat, ct_in, w0,
                                   torch.from_numpy(idx).to(card))
    out.sum().backward()
    assert kernels.group_points_cuda.launches == before + 2
    assert w0.grad is not None and torch.isfinite(w0.grad).all()


def test_probe_kernels_match_plain(card):
    """Both probe kernels on every tile of ``probes.pack.probe_tiles``
    against the plain versions bitwise."""
    from scan2cap_torch.probes import pack, shift
    for name, hit, ints in pack.probe_tiles():
        ht = torch.from_numpy(hit).to(card)
        it = torch.from_numpy(ints).to(card)
        praw, pword = pack.pack_probe_plain(ht)
        pouts = shift.shift_probe_plain(ht, it)
        before = (kernels.pack_probe_cuda.launches,
                  kernels.shift_probe_cuda.launches)
        raw, word = pack.pack_probe(ht)
        outs = shift.shift_probe(ht, it)
        assert (kernels.pack_probe_cuda.launches,
                kernels.shift_probe_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
        assert torch.equal(raw, praw) and torch.equal(word, pword), name
        for got, want in zip(outs, pouts):
            assert torch.equal(got, want), name
    assert pack.run(card)[1] == 0 and shift.run(card)[1] == 0


def test_probe_kernels_refuse_misaligned_views(card):
    """Views off the kernels' boundaries raise before a launch, and the
    card's context stays usable."""
    buf = torch.zeros(256 * 512 + 4, dtype=torch.float32, device=card)
    hit = buf[1:1 + 256 * 512].view(1, 256, 512)
    ibuf = torch.zeros(256 * 128 + 2, dtype=torch.int32, device=card)
    ints = ibuf[1:1 + 256 * 128].view(1, 256, 128)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.pack_probe_cuda(hit)
    with pytest.raises(ValueError, match="8-byte"):
        kernels.shift_probe_cuda(buf[:256 * 512].view(1, 256, 512), ints)
    raw, _ = kernels.pack_probe_cuda(buf[4:].view(1, 256, 512))
    torch.cuda.synchronize()
    assert raw.shape == (1, 256, 128)


def test_new_wrappers_check_their_inputs(card):
    x = torch.zeros((1, 64, 4), device=card)
    idx = torch.zeros((1, 2, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        kernels.group_points_cuda(x, idx.long())
    with pytest.raises(ValueError):
        kernels.group_points_cuda(x.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        kernels.pack_probe_cuda(torch.zeros((1, 256, 256), device=card))


def test_mask_votenet_forward_launches_the_lists_kernel(card):
    """MaskVoteNet's forward on the card: 5 FPS, 5 first-k (the
    aggregation's nsample 512 through the ordered scan), 5 gathers
    (sa1 gather-lean at 133 channels), and the port's CPU forward's
    indices and boxes."""
    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.data import synthetic
    from scan2cap_torch.models.mask_votenet import MaskVoteNet

    cfg = ModelConfig(num_points=8192, num_proposals=1, max_num_obj=1,
                      use_normal=True, use_multiview=True, no_caption=True)
    host = synthetic.make_mask_votenet_batch(cfg, 4, num_objects=4, seed=1)
    host["point_clouds"][..., 3:134] = np.random.RandomState(2).randn(
        4, 8192, 131).astype(np.float32) * 0.1
    outs, counts = {}, None
    for dev in ("cpu", card):
        model = MaskVoteNet(cfg, device=dev, seed=0)
        before = kernels.launch_counts()
        with torch.no_grad():
            outs[str(dev)] = model(synthetic.to_device(host, dev))
        after = kernels.launch_counts()
        counts = {k: after[k] - before[k] for k in after}
    assert counts["furthest_point_sample_cuda"] == 5
    assert counts["ball_query_cuda"] == 5
    assert counts["ball_query_ordered"] == 1
    assert counts["group_points_cuda"] == 5
    cpu, gpu = outs["cpu"], outs[str(card)]
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    for k in ("center", "size_scores", "sem_cls_scores"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=0,
                                   atol=1e-3 * float(cpu[k].abs().max()))


@pytest.mark.parametrize("mode", ["compute_dtype", "storage_dtype"])
def test_bf16_train_step_launches_only_float32_kernels(card, mode,
                                                       monkeypatch):
    """One bfloat16 train step of a narrow flagship on the card: every FPS,
    first-k and gather launch receives float32 and equals its plain
    version on the same inputs (5, 5 and 6 a step)."""
    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.data import synthetic
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.train.step import create_train_state, make_train_step

    seen = []

    def held(name, kernel, plain, n_float):
        def call(*args, **kw):
            for a in args[:n_float]:
                assert a.dtype == torch.float32, (name, a.dtype)
            got = kernel(*args, **kw)
            assert torch.equal(got, plain(*args)), name
            seen.append(name)
            return got
        return call

    monkeypatch.setattr(sampling, "furthest_point_sample_cuda", held(
        "fps", sampling.furthest_point_sample_cuda,
        sampling.furthest_point_sample_plain, 1))
    monkeypatch.setattr(grouping, "ball_query_cuda", held(
        "first_k", grouping.ball_query_cuda,
        lambda x, q, r2, ns: grouping.ball_query_plain(x, q, r2 ** 0.5, ns),
        2))
    monkeypatch.setattr(grouping, "group_points_cuda", held(
        "gather", grouping.group_points_cuda, grouping.group_points_plain, 1))
    cfg = ModelConfig(num_points=4096, sa_npoints=(512, 256, 128, 64),
                      num_proposals=64, hidden_size=64, emb_size=32,
                      num_graph_steps=2, num_locals=10, use_topdown=True,
                      use_relation=True, use_orientation=True, min_iou=-1.0,
                      **{mode: "bfloat16"})
    vocab = synthetic.make_vocab(num_vocabs=40, emb_size=cfg.emb_size)
    batch = synthetic.to_device(synthetic.make_scene_batch(
        cfg, batch_size=2, num_objects=4, vocab=vocab, seed=7), card)
    model = CapNet(cfg, num_vocabs=40, device=card)
    metrics = make_train_step(cfg, create_train_state(cfg, model),
                              detection=True, caption=True,
                              orientation=True)(batch, 1e-3, 0.1)
    assert torch.isfinite(metrics["loss"])
    assert (seen.count("fps"), seen.count("first_k"),
            seen.count("gather")) == (5, 5, 6), seen
