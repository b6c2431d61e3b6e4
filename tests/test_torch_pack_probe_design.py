"""The arithmetic of the pack-tile probe kernels (``csrc/pack_probe.cu``),
emulated in numpy on the CPU and held bitwise against the plain versions
(``probes.pack.pack_probe_plain``, ``probes.shift.shift_probe_plain``),
which ``tests/test_torch_probes.py`` holds against the TPU scripts' Pallas
kernels.  The kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_kernels.py``).

Emulated here, with the source's own layout constants:
  * shared memory as bytes: the hit boxes as the TMA writes them (128-byte
    swizzle), the P^T template as the kernel's loop writes it, and both
    read back through wgmma's descriptor addressing (start address, LBO,
    SBO, swizzle, the advance per K step of 8 points);
  * the m64n48 accumulator fragment: which thread and register hold each
    row and column;
  * the partition: the SPLIT blocks of a cluster, their K slices summed in
    float32 in random orders, the 8-row groups sent to their owners and
    summed there in random orders, the zero padding of each block's row
    share, and the epilogue from the fragment's registers.
"""

import os
import re

import numpy as np
import pytest
import torch

from scan2cap_torch.kernels import pack_probe as wrapper
from scan2cap_torch.probes import pack, shift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "scan2cap_torch", "csrc", "pack_probe.cu")
MQ, NC, OUT = wrapper.MQ, wrapper.NC, wrapper.OUT
TILES = {name: (hit, ints) for name, hit, ints in pack.probe_tiles()}


def _source():
    with open(SRC) as f:
        return f.read()


def _constant(name):
    m = re.search(rf"constexpr [\w ]+ {name} = ([^;]+);", _source())
    assert m, name
    return m.group(1).strip()


# the layout the source names
SWIZZLE = int(_constant("kSwizzleBytes"))            # 128
GROUP = int(_constant("kGroupBytes"))                # hits' SBO
STEP = int(_constant("kStepBytes"))                  # hits' K step
TEMPLATE_ROWS = 48 + 16 - 1
TEMPLATE_LEAD = TEMPLATE_ROWS * 16                   # template's LBO
TEMPLATE_STRIDE = 8 * 16                             # template's SBO
BOX_BYTES = 64 * SWIZZLE


def test_the_source_names_the_emulated_layout():
    src = _source()
    assert (SWIZZLE, GROUP, STEP) == (128, 1024, 32)
    assert _constant("kLayoutSwizzle128") == "1"
    assert _constant("kTemplateRows") == "kCols + kWords - 1"
    assert _constant("kTemplateLead") == "kTemplateRows * 16"
    assert _constant("kTemplateStride") == "8 * 16"
    # word j's slice starts 15 - j template rows in; a K step of 8 points
    # is 32 bytes of a swizzled hit row and two template chunks
    assert "smem_addr(s_pack) + 16 * (15 - (word0 + b))" in src
    assert "hit_descriptor(a + s * kStepBytes)" in src
    assert "pack_descriptor(p + s * 2 * kTemplateLead)" in src
    assert "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src
    # the wrapper's partition is the one the source builds
    assert _constant("kSplit") == str(wrapper.SPLIT)


# --- shared memory and the descriptors -----------------------------------
def _descriptor(addr, lbo, sbo, layout):
    """The 64-bit wgmma descriptor as the kernel packs it."""
    return (((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32
            | layout << 62)


def _decode(desc):
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, layout=desc >> 62)


def _read(smem, desc, rows):
    """The (rows, 8) tf32 operand wgmma reads through `desc`: K-major, row r
    in 8-row group r // 8 (SBO apart); with the 128-byte swizzle rows of a
    group lie 128 bytes apart and 16-byte chunk c of a line sits at c ^
    (line % 8); without it a core matrix is 8 rows x 16 bytes, K chunks of
    4 values LBO apart."""
    d = _decode(desc)
    r = np.arange(rows)[:, None]
    k = np.arange(8)[None, :]
    if d["layout"] == 1:
        addr = d["start"] + (r // 8) * d["sbo"] + (r % 8) * 128 + k * 4
        addr = addr ^ (((addr >> 7) & 7) << 4)
    else:
        assert d["layout"] == 0
        addr = (d["start"] + (r // 8) * d["sbo"] + (r % 8) * 16
                + (k // 4) * d["lbo"] + (k % 4) * 4)
    return smem.view(np.float32)[addr // 4]


def _tma_box(smem, base, tile_rows):
    """A (64, 32) float32 box written as the TMA's 128-byte swizzle lays it:
    16-byte chunk c of row r at chunk c ^ (r % 8) of line r."""
    words = tile_rows.view(np.uint32)
    for r in range(64):
        for c in range(8):
            at = base + r * 128 + ((c ^ (r % 8)) << 4)
            smem[at:at + 16] = words[r, 4 * c:4 * c + 4].view(np.uint8)


def _template(smem, base):
    """The kernel's loop that writes the P^T template."""
    f = smem.view(np.float32)
    for c in range(TEMPLATE_ROWS * 8):
        ch, e = divmod(c, TEMPLATE_ROWS)
        t, x = e - 15, (ch & 3) * 4
        v = [0.0] * 4
        if (t == 0 and ch < 4) or (t == 16 and ch >= 4):
            v = [2.0 ** (x + i) for i in range(4)]
        elif t == 32:
            v = [1.0] * 4
        at = (base + ch * TEMPLATE_LEAD + 16 * e) // 4
        f[at:at + 4] = v


@pytest.mark.parametrize("word", range(16))
def test_pack_template_through_its_descriptor_gives_the_pack_matrix(word):
    smem = np.zeros(16 * 1024, np.uint8)
    base = 4096                                   # any 16-byte boundary
    _template(smem, base)
    P = pack.pack_matrix().numpy()                # (512, 48)
    start = base + 16 * (15 - word)
    for s in range(4):
        desc = _descriptor(start + s * 2 * TEMPLATE_LEAD, TEMPLATE_LEAD,
                           TEMPLATE_STRIDE, 0)
        got = _read(smem, desc, 48)               # (48, 8): P^T rows
        want = P[32 * word + 8 * s:32 * word + 8 * s + 8].T
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile,word", [(0, 0), (1, 5), (2, 14), (3, 15)])
def test_hit_box_through_its_swizzled_descriptor_gives_the_tile(tile, word):
    hit = TILES["patterns_32bit"][0][0]
    smem = np.zeros(3 * BOX_BYTES, np.uint8)
    base = 2 * BOX_BYTES                          # a swizzle group boundary
    rows = np.ascontiguousarray(
        hit[64 * tile:64 * tile + 64, 32 * word:32 * word + 32])
    _tma_box(smem, base, rows)
    for s in range(4):
        desc = _descriptor(base + s * STEP, 16, GROUP, 1)
        np.testing.assert_array_equal(_read(smem, desc, 64),
                                      rows[:, 8 * s:8 * s + 8])


def test_descriptor_fields_hold_every_address_the_kernel_forms():
    # a block holds 16 / SPLIT boxes, the template, the partial sums it
    # receives, barriers and the alignment's slack
    top = ((16 // wrapper.SPLIT) * (BOX_BYTES + 8) + 8 * TEMPLATE_LEAD
           + 8 * 3 * 32 * 16 + 1024 + 8)
    assert top < 1 << 18                          # 14 bits of 16 bytes
    for lbo, sbo, layout in ((16, GROUP, 1),
                             (TEMPLATE_LEAD, TEMPLATE_STRIDE, 0)):
        desc = _descriptor(top, lbo, sbo, layout)
        assert _decode(desc) == dict(start=top & ~15, lbo=lbo, sbo=sbo,
                                     layout=layout)


# --- the accumulator fragment --------------------------------------------
def _fragment():
    """(thread, register) -> (row, column) of the m64n48 f32 fragment:
    register i of thread 32 w + lane holds row 16 w + lane / 4 + 8 ((i >> 1)
    & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1)."""
    t = np.arange(128)[:, None]
    i = np.arange(24)[None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * (t % 4) + (i & 1)
    return row, col


def test_fragment_covers_the_tile_once():
    row, col = _fragment()
    cells = row * 48 + col
    assert sorted(cells.ravel().tolist()) == list(range(64 * 48))


def test_fragment_holds_a_words_three_columns_in_one_thread():
    row, col = _fragment()
    for t in range(128):
        for i in range(24):
            k = col[t, i]
            if k >= 16:
                continue
            # the epilogue's registers: low 4a + 2 half + e, high +8,
            # count +16
            a, e, half = k // 8, i & 1, (i >> 1) & 1
            assert i == 4 * a + 2 * half + e
            for off, c in ((8, 16 + k), (16, 32 + k)):
                assert (row[t, i + off], col[t, i + off]) == (row[t, i], c)


# --- the partition, the exchange, the epilogue ----------------------------
def _tf32(x):
    """What the tensor cores read of a float32: its top 19 bits."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _sum_in_order(terms, order):
    """float32 sum of terms[k] in the given order."""
    acc = np.zeros(terms.shape[1:], np.float32)
    for k in order:
        acc = acc + terms[k]
    return acc


def _emulate(hit, ints, split, seed):
    """Both probes as the kernel computes them at `split`: raw, word and
    the six shift outputs, (MQ, OUT) each, from outputs that start as a
    sentinel so that an element no block writes shows."""
    rs = np.random.RandomState(seed)
    P = _tf32(pack.pack_matrix().numpy())
    a = _tf32(hit[0])
    owned = 8 // split
    sentinel = np.int32(0x7BADBEEF)
    raw = np.full((MQ, OUT), sentinel, np.int32).view(np.float32)
    outs = np.full((7, MQ, OUT), sentinel, np.int32)   # word, v0..v5
    row, col = _fragment()
    for tile in range(MQ // 64):
        rows = slice(64 * tile, 64 * tile + 64)
        # each block's partial sum over its K slice, products in any order
        partial = []
        for rank in range(split):
            ks = np.arange(NC // split) + rank * (NC // split)
            terms = a[rows, ks].T[:, :, None] * P[ks][:, None, :]
            partial.append(_sum_in_order(terms, rs.permutation(len(ks))))
        for rank in range(split):
            # zero padding of this block's row share
            share = slice(64 * tile + rank * 64 // split,
                          64 * tile + (rank + 1) * 64 // split)
            raw[share, 48:] = 0.0
            outs[:, share, 16:] = 0
        for g in range(8):                       # 8-row groups, by owner
            owner = g // owned
            sent = [partial[r] for r in range(split) if r != owner]
            order = rs.permutation(len(sent))
            total = partial[owner].copy()
            for j in order:
                total = total + sent[j]
            # the owner's threads holding group g: warp g // 2, half g % 2
            for t in range(32 * (g // 2), 32 * (g // 2) + 32):
                half = g % 2
                for i in range(24):
                    if (i >> 1) & 1 != half:
                        continue
                    r, c = row[t, i], col[t, i]
                    raw[64 * tile + r, c] = total[r, c]
                    if c < 16:
                        lo = np.uint32(np.int32(total[r, c]))
                        hi = np.uint32(np.int32(total[r, 16 + c]))
                        x = np.uint32(ints[0, 64 * tile + r, c])
                        with np.errstate(over="ignore"):
                            v = (lo | (hi << np.uint32(16)),
                                 lo | (hi * np.uint32(65536)),
                                 lo + (hi << np.uint32(16)),
                                 lo | ((hi << np.uint32(8)) << np.uint32(8)),
                                 x << np.uint32(16),
                                 lo | (hi << np.uint32(16 & 31)))
                        outs[0, 64 * tile + r, c] = np.int32(v[0].view(np.int32))
                        for n, w in enumerate(v):
                            outs[1 + n, 64 * tile + r, c] = w.view(np.int32)
    return raw, outs


def _hold(hit, ints, split, seed=0):
    raw, outs = _emulate(hit, ints, split, seed)
    h, i = torch.from_numpy(hit), torch.from_numpy(ints)
    praw, pword = pack.pack_probe_plain(h)
    np.testing.assert_array_equal(raw.view(np.int32),
                                  praw[0].numpy().view(np.int32))
    np.testing.assert_array_equal(outs[0], pword[0].numpy())
    for v, want in enumerate(shift.shift_probe_plain(h, i)):
        np.testing.assert_array_equal(outs[1 + v], want[0].numpy(),
                                      err_msg=shift.NAMES[v])


@pytest.mark.parametrize("name", list(TILES))
def test_partition_and_epilogue_emulated_equal_the_plain_versions(name):
    hit, ints = TILES[name]
    _hold(hit, ints, wrapper.SPLIT, seed=len(name))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.1, 0.25, 0.75, 0.9, 0.99,
                                     1.0])
def test_density_sweep_emulated_equals_the_plain_versions(density):
    rs = np.random.RandomState(int(density * 100) + 11)
    hit = (rs.rand(1, MQ, NC) < density).astype(np.float32)
    ints = rs.randint(0, 65536, (1, MQ, OUT)).astype(np.int32)
    _hold(hit, ints, wrapper.SPLIT, seed=3)


def test_exchange_covers_every_slot_once():
    split = wrapper.SPLIT
    owned = 8 // split
    for owner in range(split):
        slots = []
        for sender in range(split):
            if sender == owner:
                continue
            for g in range(8):
                if g // owned != owner:
                    continue
                for m in range(3):
                    for lane in range(32):
                        slots.append(((sender * owned + g % owned) * 3 + m)
                                     * 32 + lane)
        # distinct float4 slots inside the block's 12 KB, and the bytes
        # its barrier expects
        assert len(set(slots)) == len(slots)
        assert all(0 <= s < 8 * 3 * 32 for s in slots)
        assert len(slots) * 16 == (split - 1) * owned * 3 * 32 * 16
    # every 8-row group has one owner, every block the same number
    owners = [g // owned for g in range(8)]
    assert sorted(set(owners)) == list(range(split))


def test_tf32_leaves_a_probe_tile_exact_and_truncates_others():
    for hit, _ in TILES.values():
        np.testing.assert_array_equal(_tf32(hit), hit)
    P = pack.pack_matrix().numpy()
    np.testing.assert_array_equal(_tf32(P), P)
    # outside the contract: a value that is not 0/1 loses mantissa bits
    x = np.float32([0.3, 1.0 / 3.0])
    assert (_tf32(x) != x).all()
    assert "tf32" in wrapper.pack_probe_cuda.__doc__ + wrapper.__doc__


def test_probe_tiles_are_the_named_ones():
    assert list(TILES) == ["crafted", "random", "all_ones", "zeros",
                           "density_0.05", "density_0.5", "patterns_32bit",
                           "lo_hi_65535_rows"]
    for name, (hit, ints) in TILES.items():
        assert hit.shape == (1, MQ, NC) and hit.dtype == np.float32
        assert ints.shape == (1, MQ, OUT) and ints.dtype == np.int32
        assert set(np.unique(hit)) <= {0.0, 1.0}, name
    assert not TILES["zeros"][0].any()
    assert abs(TILES["density_0.05"][0].mean() - 0.05) < 0.005
    assert abs(TILES["density_0.5"][0].mean() - 0.5) < 0.01
    _, word = pack.pack_probe_plain(torch.from_numpy(
        TILES["patterns_32bit"][0]))
    words = word[0, :, :16].numpy()
    assert len({tuple(r) for r in words}) == MQ     # a pattern a row
    _, word = pack.pack_probe_plain(torch.from_numpy(
        TILES["lo_hi_65535_rows"][0]))
    assert (word[0, ::2, :16] == -1).all()          # 0xFFFFFFFF
    assert (word[0, 1::2, :16] != -1).any()


def _view(dtype, shape, offset_bytes):
    """A contiguous tensor of `shape` whose address lies `offset_bytes`
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    base = torch.zeros(n + 16 // size, dtype=dtype)
    skip = (16 - base.data_ptr() % 16) % 16 + offset_bytes
    t = base[skip // size:skip // size + n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == offset_bytes
    return t


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_wrappers_refuse_views_off_the_kernels_boundaries(offset):
    """The TMA's tensor map needs the hit tile on a 16-byte boundary and
    the shift epilogue reads ``ints`` 8 bytes at a time: a view off those
    raises (a launch would fault the card's context), before the device
    is looked at; an aligned one gets as far as the device check."""
    hit = _view(torch.float32, (1, MQ, NC), offset)
    ints = torch.zeros((1, MQ, OUT), dtype=torch.int32)
    with pytest.raises(ValueError, match="hit must start on a 16-byte"):
        wrapper.pack_probe_cuda(hit)
    with pytest.raises(ValueError, match="hit must start on a 16-byte"):
        wrapper.shift_probe_cuda(hit, ints)
    hit = _view(torch.float32, (1, MQ, NC), 0)
    ints = _view(torch.int32, (1, MQ, OUT), offset)
    if offset % 8:
        with pytest.raises(ValueError, match="ints must start on an? 8-byte"):
            wrapper.shift_probe_cuda(hit, ints)
    else:
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper.shift_probe_cuda(hit, ints)


def test_wrappers_refuse_cpu_tensors():
    hit = torch.zeros((1, MQ, NC))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper.pack_probe_cuda(hit)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper.shift_probe_cuda(hit, torch.zeros((1, MQ, OUT),
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper.empty_launch_cuda(torch.device("cpu"))


# --- the new tiles through the TPU scripts' own kernels --------------------
NEW_TILES = ["zeros", "density_0.05", "density_0.5", "patterns_32bit",
             "lo_hi_65535_rows"]


def _script(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_design_probe_script_{name}",
        os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NEW_TILES)
def test_plain_versions_match_the_pallas_kernels_on_the_new_tiles(name):
    """The TPU scripts' kernels in interpret mode (as
    tests/test_torch_probes.py runs them) on the tiles the card's kernels
    are now also held to."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    hit, ints = TILES[name]
    with pltpu.force_tpu_interpret_mode():
        raw, word = (np.asarray(x) for x in _script(
            "micro_mxu_pack_probe").probe(jnp.asarray(hit)))
        want = [np.asarray(x) for x in _script(
            "micro_mxu_shift_probe").probe(jnp.asarray(hit),
                                           jnp.asarray(ints))]
    got_raw, got_word = pack.pack_probe_plain(torch.from_numpy(hit))
    np.testing.assert_array_equal(got_raw.numpy(), raw)
    np.testing.assert_array_equal(got_word.numpy(), word)
    got = shift.shift_probe_plain(torch.from_numpy(hit),
                                  torch.from_numpy(ints))
    for n, g, w in zip(shift.NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=n)
