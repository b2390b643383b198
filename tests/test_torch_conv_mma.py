"""The tensor-core conv tile (``csrc/conv_mma.cuh``) emulated on the CPU.

The fused conv layer (``csrc/conv_block.cu``) and the unfused 2x2 conv
(``csrc/binary_conv2x2.cu``) are binary implicit GEMMs on
``mma.sync.m16n8k256 .b1 .and.popc``: K runs over a position's 2x2 window,
4 taps x Cw words padded with zero words to 256-bit steps, lane t of a quad
holds the step's words 2t and 2t + 1, and the XNOR count comes from the AND
count by ``popc(a ^ w) = popc(a) + popc(w) - 2 popc(a & w)``.  No CUDA
kernel runs here, so :func:`emulate` repeats the kernels' arithmetic lane
by lane at the wrapper's own launch geometry (``conv_tiles``): the staged
band and taps, each warp's m16 tiles, the fragments the MMA reads, the
per-lane epilogue with its shuffles.  It is held bit-exact (tolerance 0)
against the plain versions (``accumulate_tap_popcounts``,
``conv_block_body``, ``binary_conv2x2_plain``) and against ``repro``'s
Pallas kernels in interpret mode; the launch geometry is held to cover
every output once, to keep pool windows whole and to fit shared memory.
The kernels themselves are held against the plain versions on the card
by ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binary_conv2x2 as jbc
from repro.kernels import binary_conv2x2_block as jbcb
from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import binary_conv2x2 as bc
from repro_torch.kernels import binary_conv2x2_block as bcb
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _popc(x) -> np.ndarray:
    return np.bitwise_count(np.asarray(x, dtype=np.uint32)).astype(np.int64)


def _band(t, bx, ho, wo):
    """conv_mma.cuh band_of: (frame, row0, col0, rows, cols) of block bx."""
    frame, rem = divmod(bx, t.bands * t.chunks)
    band, chunk = divmod(rem, t.chunks)
    row0, col0 = band * t.rows, chunk * t.cols
    return frame, row0, col0, min(t.rows, ho - row0), min(t.cols, wo - col0)


def _row_of(r, row0, col0, windows, cols, pitch, cw, wo, pool):
    """conv_mma.cuh row_of, over arrays of band rows r: (base, out)."""
    win = (r >> 4) * 4 + (r & 3) if pool else r
    yo, xo = win // cols, win % cols
    y, x = yo, xo
    if pool:
        corner = (r >> 2) & 3
        y, x = 2 * yo + (corner >> 1), 2 * xo + (corner & 1)
    pad = win >= windows
    return (np.where(pad, 0, y * pitch + x * cw),
            np.where(pad, -1, (row0 + yo) * wo + col0 + xo))


def _stage(flat_a, t, frame, row0, col0, rows, h, wd, cw, pool):
    """conv_mma.cuh stage_band: the band's input rows, pitch words apart
    (the words between a row's columns and the pitch stay unread)."""
    in_row0, in_col0 = (2 * row0, 2 * col0) if pool else (row0, col0)
    in_rows = 2 * rows + 1 if pool else rows + 1
    n = min(t.in_cols, wd - in_col0) * cw
    sa = np.zeros(in_rows * t.pitch + 1, np.uint32)
    for r in range(in_rows):
        src = ((frame * h + in_row0 + r) * wd + in_col0) * cw
        sa[r * t.pitch:r * t.pitch + n] = flat_a[src:src + n]
    return sa


def _shfl_xor(v, m):
    return v[LANES ^ m]


def _quad_sum(v):
    v = v + _shfl_xor(v, 1)
    return v + _shfl_xor(v, 2)


def emulate(a, w, c, *, tau=None, flip=None, pool=False, trace=None,
            tiles=None):
    """The conv_mma.cuh kernels' arithmetic, lane by lane, on numpy words.

    a: (B, H, W, Cw) uint32; w: (F, 4, Cw) uint32.  With ``tau``/``flip``
    it is conv_block.cu (packed (B, Ho, Wo, F/32) uint32 words), without
    them binary_conv2x2.cu ((B, H-1, W-1, F) int64 sums).  Raises if an
    output is written twice or never.  ``trace`` (a list) collects
    (block, band row, window, corner) for every pooled product row.
    ``tiles`` is the launch geometry (default the wrapper's,
    ``conv_tiles``; a ``make_conv_tiles`` one for the autotuner's).
    """
    fused = tau is not None
    b, h, wd, cw = a.shape
    f = w.shape[0]
    k4 = 4 * c
    tiles = tiles or bcb.conv_tiles(b, h, wd, f, cw, pool)
    ho, wo = bcb.conv_out(h, wd, pool)
    kpad = tiles.ksteps * 8
    nblk = 32 * tiles.nslices
    fwords = f // 32
    out = np.zeros((b, ho * wo, fwords if fused else f),
                   np.uint32 if fused else np.int64)
    writes = np.zeros(out.shape, np.int64)
    flat_a, flat_w = a.reshape(-1), w.reshape(-1)
    for bx in range(tiles.grid[0]):
        frame, row0, col0, rows, cols = _band(tiles, bx, ho, wo)
        windows = rows * cols
        sa = _stage(flat_a, tiles, frame, row0, col0, rows, h, wd, cw, pool)
        for by in range(tiles.grid[1]):
            n0 = by * nblk
            sb = np.zeros((nblk, tiles.kstride), np.uint32)
            nf = min(nblk, f - n0)
            sb[:nf, :4 * cw] = flat_w.reshape(f, 4 * cw)[n0:n0 + nf]
            kconst = k4 - 2 * _popc(sb[:, :kpad]).sum(axis=1)
            for warp in range(bcb.WARPS):
                sl = warp % tiles.nslices
                f0 = n0 + 32 * sl
                if f0 >= f:
                    continue
                fi = 32 * sl + 8 * np.arange(4)[None, :, None] \
                    + 2 * T[:, None, None] + np.arange(2)[None, None, :]
                kc = kconst[fi]                                # (32, 4, 2)
                tiles_m = -(-(4 * windows if pool else windows) // 16)
                for mt in range(warp // tiles.nslices, tiles_m,
                                bcb.WARPS // tiles.nslices):
                    base0, out0 = _row_of(16 * mt + G, row0, col0, windows,
                                          cols, tiles.pitch, cw, wo, pool)
                    base1, out1 = _row_of(16 * mt + G + 8, row0, col0,
                                          windows, cols, tiles.pitch, cw, wo,
                                          pool)
                    if trace is not None and pool:
                        for r in range(16):
                            win = (r >> 4) * 4 + (r & 3) + 4 * mt
                            trace.append((bx, by, 16 * mt + r, win,
                                          (r >> 2) & 3))
                    # every K step s at once: lane t of a quad reads the
                    # step's words 2t and 2t + 1 (kw), the taps' halves
                    # a pitch apart past 2 Cw words
                    kw = 8 * np.arange(tiles.ksteps)[:, None] + 2 * T
                    valid = kw < 4 * cw
                    seg = (kw >= 2 * cw).astype(np.int64)
                    off = kw + seg * (tiles.pitch - 2 * cw)
                    pair = []
                    for base in (base0, base1):
                        idx = np.where(valid, base + off, 0)
                        pair.append((np.where(valid, sa[idx], 0),
                                     np.where(valid, sa[idx + 1], 0)))
                    (a0x, a0y), (a1x, a1y) = pair              # (S, 32)
                    pa = np.stack([(_popc(a0x) + _popc(a0y)).sum(axis=0),
                                   (_popc(a1x) + _popc(a1y)).sum(axis=0)],
                                  axis=1)
                    # the fragments: A rows 0-7 from a0 of lanes (g, t),
                    # rows 8-15 from a1; B column n of n8 tile j from
                    # lanes (n, t), row 32 sl + 8 j + n
                    nsteps = tiles.ksteps
                    alo = np.concatenate([a0x.reshape(nsteps, 8, 4),
                                          a1x.reshape(nsteps, 8, 4)], axis=1)
                    ahi = np.concatenate([a0y.reshape(nsteps, 8, 4),
                                          a1y.reshape(nsteps, 8, 4)], axis=1)
                    brow = 32 * sl + 8 * np.arange(4)[:, None] + G  # (4, 32)
                    blo = sb[brow[None], kw[:, None, :]].reshape(
                        nsteps, 4, 8, 4)
                    bhi = sb[brow[None], kw[:, None, :] + 1].reshape(
                        nsteps, 4, 8, 4)
                    prod = (_popc(alo[:, None, :, None, :]
                                  & blo[:, :, None])
                            + _popc(ahi[:, None, :, None, :]
                                    & bhi[:, :, None])
                            ).sum(axis=(0, -1))                # (4, 16, 8)
                    acc = np.stack([prod[:, G, 2 * T].T,
                                    prod[:, G, 2 * T + 1].T,
                                    prod[:, G + 8, 2 * T].T,
                                    prod[:, G + 8, 2 * T + 1].T], axis=-1)
                    pa0, pa1 = _quad_sum(pa[:, 0]), _quad_sum(pa[:, 1])
                    s0 = kc - 2 * pa0[:, None, None] + 4 * acc[:, :, 0:2]
                    s1 = kc - 2 * pa1[:, None, None] + 4 * acc[:, :, 2:4]
                    if not fused:
                        for pos, s in ((out0, s0), (out1, s1)):
                            for lane in np.flatnonzero(pos >= 0):
                                fcol = f0 + (fi[lane] - 32 * sl).reshape(-1)
                                keep = fcol < f
                                out[frame, pos[lane], fcol[keep]] = \
                                    s[lane].reshape(-1)[keep]
                                writes[frame, pos[lane], fcol[keep]] += 1
                        continue
                    th = tau[n0 + fi].astype(np.int64)
                    fl = flip[n0 + fi].astype(np.int64) & 1
                    shift = (8 * np.arange(4)[None, :, None]
                             + 2 * T[:, None, None]
                             + np.arange(2)[None, None, :])
                    w0 = (((s0 >= th) ^ fl ^ 1) << shift).sum(axis=(1, 2))
                    w1 = (((s1 >= th) ^ fl ^ 1) << shift).sum(axis=(1, 2))
                    if pool:
                        w0 = w0 & w1
                        w0 = w0 & _shfl_xor(w0, 16)
                    for m in (1, 2):
                        w0 = w0 | _shfl_xor(w0, m)
                        w1 = w1 | _shfl_xor(w1, m)
                    fw = n0 // 32 + sl
                    stores = ([(out0, w0, (T == 0) & (G < 4))] if pool else
                              [(out0, w0, T == 0), (out1, w1, T == 0)])
                    for pos, word, lanes in stores:
                        for lane in np.flatnonzero(lanes & (pos >= 0)):
                            out[frame, pos[lane], fw] = word[lane]
                            writes[frame, pos[lane], fw] += 1
    if not (writes == 1).all():
        raise AssertionError(f"outputs written {np.unique(writes)} times")
    return out.reshape((b, ho, wo, out.shape[-1]))


def _case(rng, b, h, w, c, f):
    cw = -(-c // 32)
    a, wt = _words(rng, (b, h, w, cw)), _words(rng, (f, 4, cw))
    tau = rng.integers(-4 * c, 4 * c + 1, f).astype(np.int32)
    tau[:2] = [-2 ** 31, 2 ** 31 - 256][:f]           # saturated neurons
    flip = rng.integers(0, 2, f).astype(np.int32)
    return a, wt, tau, flip


# ---------------------------------------------------------------------------
# the arithmetic: AND counts and the identity vs the XOR popcounts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cw", [1, 2, 3, 4, 8, 64])
def test_and_count_identity_matches_tap_popcounts(cw):
    """Full-range words (bits past any c live): the emulated sums equal
    4c - 2 accumulate_tap_popcounts at every Cw, including K padded to a
    256-bit step (Cw 1 and 3) and 32 steps (Cw 64)."""
    rng = np.random.default_rng(cw)
    b, h, w, f = 2, 5, 6, 40
    a, wt = _words(rng, (b, h, w, cw)), _words(rng, (f, 4, cw))
    c = 32 * cw
    got = emulate(a, wt, c)
    xor = bcb.accumulate_tap_popcounts(_i32(a), _i32(wt), h, w)
    np.testing.assert_array_equal(got, 4 * c - 2 * xor.numpy())


# c on and off the word grid (1, 40, 70, 2048), ragged F, 3 frames
@pytest.mark.parametrize("b,h,w,c,f", [(3, 8, 9, 40, 16), (2, 6, 7, 1, 33),
                                       (1, 7, 5, 70, 40), (2, 4, 6, 2048, 1),
                                       (3, 9, 9, 64, 64)])
def test_unfused_emulation_vs_plain_and_pallas(b, h, w, c, f):
    rng = np.random.default_rng(b * 1000 + c + f)
    a, wt, _, _ = _case(rng, b, h, w, c, f)
    got = emulate(a, wt, c)
    plain = bc.binary_conv2x2_plain(_i32(a), _i32(wt), c)
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(jbc.binary_conv2x2(jnp.asarray(a), jnp.asarray(wt),
                                         c=c, interpret=True))
    np.testing.assert_array_equal(got, want)


# Cw 1, 2, 4, 8; pooled conv outputs of odd size (31 -> 15 at the chip's
# S=4 width; 13 -> 6 and 5 -> 2 at S=1) and of even size; tau at the int32
# extremes in every case
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(2, 6, 7, 32), (2, 9, 7, 64),
                                     (1, 32, 32, 64), (2, 14, 14, 128),
                                     (2, 14, 14, 256), (3, 6, 6, 256)])
def test_fused_emulation_vs_plain_and_pallas(b, h, w, c, pool):
    rng = np.random.default_rng(h * 100 + c + pool)
    a, wt, tau, flip = _case(rng, b, h, w, c, c)
    got = emulate(a, wt, c, tau=tau, flip=flip, pool=pool)
    plain = bcb.conv_block_body(_i32(a), _i32(wt), torch.from_numpy(tau),
                                torch.from_numpy(flip), k4=4 * c, h=h, wd=w,
                                pool=pool)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
    want = np.asarray(jbcb.binary_conv2x2_block(
        jnp.asarray(a), jnp.asarray(wt), jnp.asarray(tau), jnp.asarray(flip),
        c=c, pool=pool, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,w,c,f,pool", [(1, 2, 420, 2048, 8, None),
                                             (1, 3, 2500, 256, 32, True),
                                             (1, 2, 4000, 256, 32, False)])
def test_emulation_in_column_chunks_vs_plain(b, h, w, c, f, pool):
    """Maps too wide for one whole staged row (the unfused conv at Cw 64,
    the fused layer at Cw 8, pooled and not): the bands are column chunks,
    and the emulation still equals the plain versions."""
    rng = np.random.default_rng(w)
    a, wt, tau, flip = _case(rng, b, h, w, c, f)
    tiles = bcb.conv_tiles(b, h, w, f, c // 32, bool(pool))
    assert tiles.chunks > 1
    if pool is None:
        np.testing.assert_array_equal(
            emulate(a, wt, c),
            bc.binary_conv2x2_plain(_i32(a), _i32(wt), c).numpy())
        return
    got = emulate(a, wt, c, tau=tau, flip=flip, pool=pool)
    plain = bcb.conv_block_body(_i32(a), _i32(wt), torch.from_numpy(tau),
                                torch.from_numpy(flip), k4=4 * c, h=h, wd=w,
                                pool=pool)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))


def test_fused_emulation_at_cifar9_s1_last_layers():
    """S=1's 13x13 and 5x5 pooled layers at B=8 (one m16 tile a frame at
    5x5): the emulation equals the plain version."""
    rng = np.random.default_rng(3)
    for h in (13, 5):
        a, wt, tau, flip = _case(rng, 8, h, h, 256, 256)
        got = emulate(a, wt, 256, tau=tau, flip=flip, pool=True)
        plain = bcb.conv_block_body(_i32(a), _i32(wt), torch.from_numpy(tau),
                                    torch.from_numpy(flip), k4=1024, h=h,
                                    wd=h, pool=True)
        np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

def _registry_layers():
    layers = []
    for name in sorted(networks.REGISTRY):
        for _, h, w, c, f, pool in (st for st in interpreter.compile_plan(
                networks.REGISTRY[name]()).mega if st[0] == "conv"):
            layers.append((name, h, w, c, f, pool))
    return layers


@pytest.mark.parametrize("batch", [1, 3, 8, 256])
def test_conv_tiles_fit_shared_memory_at_every_registry_layer(batch):
    for name, h, w, c, f, pool in _registry_layers():
        for fused in (True, False):
            t = bcb.conv_tiles(batch, h, w, f, c // 32, pool and fused)
            assert t.smem <= bcb.SMEM_LIMIT, (name, h, w, c, pool, t)
            assert t.kstride % 16 == 8 and t.kstride >= 8 * t.ksteps
            assert 8 * t.ksteps >= 4 * (c // 32)
            assert t.nslices in (1, 2, 4, 8)
            assert t.grid[1] * 32 * t.nslices >= f


@pytest.mark.parametrize("cw", [1, 3, 8, 16, 33, 64])
def test_conv_tiles_fit_the_unfused_shapes_up_to_64_words(cw):
    """Every map the unfused conv is given (the chip's, up to 32x32, and
    repro's odd ones) at every Cw up to 64: within 227 KB, in whole rows."""
    for b, h, w in ((8, 32, 32), (1, 31, 31), (5, 12, 7), (2, 2, 2),
                    (3, 8, 9)):
        for f in (1, 33, 256):
            t = bcb.conv_tiles(b, h, w, f, cw, False)
            assert t.smem <= bcb.SMEM_LIMIT, (b, h, w, f, cw, t)
            assert t.chunks == 1 and t.pitch == w * cw


@pytest.mark.parametrize("cw,pool", [(64, False), (1, False), (8, True),
                                     (8, False)])
@pytest.mark.parametrize("w", [3, 441, 3700, 100_000])
def test_conv_tiles_take_any_width(w, cw, pool):
    """Maps too wide for one staged row are cut into column chunks that
    fit 227 KB and cover the row; a staged row keeps its source's
    alignment (pitch = W Cw mod 4 words)."""
    t = bcb.conv_tiles(2, 5, w, 256, cw, pool)
    _, wo = bcb.conv_out(5, w, pool)
    assert t.smem <= bcb.SMEM_LIMIT
    assert t.chunks * t.cols >= wo > (t.chunks - 1) * t.cols
    assert t.in_cols * cw <= t.pitch and (t.pitch - w * cw) % 4 == 0
    assert (t.chunks == 1) == (t.pitch == w * cw)
    assert t.chunks == 1 if w == 3 else True
    assert t.chunks > 1 if w == 100_000 else True


def _covered(b, h, w, f, cw, pool):
    """Every (frame, output position) and the band row of each product row
    that computes it, by walking conv_tiles' blocks and warps."""
    t = bcb.conv_tiles(b, h, w, f, cw, pool)
    ho, wo = bcb.conv_out(h, w, pool)
    seen = {}
    for bx in range(t.grid[0]):
        frame, row0, col0, rows, cols = _band(t, bx, ho, wo)
        windows = rows * cols
        n_rows = 4 * windows if pool else windows
        for warp in range(bcb.WARPS // t.nslices):
            for mt in range(warp, -(-n_rows // 16), bcb.WARPS // t.nslices):
                r = 16 * mt + np.arange(16)
                _, out = _row_of(r, row0, col0, windows, cols, t.pitch, cw,
                                 wo, pool)
                for ri, o in zip(r, out):
                    if o >= 0:
                        seen.setdefault((frame, int(o)), []).append(
                            (bx, int(mt), int(ri)))
    return seen, ho * wo


# the chip's maps, odd ones, and maps too wide for one whole staged row
# (column chunks: W 2500 at Cw 8 pooled, 4000 at Cw 8, 500 at Cw 64)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("b,h,w,cw", [(8, 32, 32, 8), (8, 31, 31, 8),
                                      (3, 29, 29, 8), (8, 14, 14, 8),
                                      (8, 13, 13, 8), (3, 6, 6, 8),
                                      (8, 5, 5, 8), (2, 9, 7, 8),
                                      (2, 5, 2500, 8), (1, 3, 4000, 8),
                                      (2, 4, 500, 64)])
def test_conv_tiles_cover_every_output_once(b, h, w, cw, pool):
    """Each output position is one product row (four with pool) of one
    block's band, and a pool window's four rows lie in one m16 tile."""
    seen, per_frame = _covered(b, h, w, 256, cw, pool)
    assert sorted(seen) == [(fr, p) for fr in range(b)
                            for p in range(per_frame)]
    for rows in seen.values():
        assert len(rows) == (4 if pool else 1)
        if pool:
            assert len({(bx, mt) for bx, mt, _ in rows}) == 1
            # corners (dy, dx) in row order: lane g holds corners g >> 2
            # and 2 + (g >> 2), lane g ^ 4 the other two
            assert sorted((ri >> 2) & 3 for _, _, ri in rows) == [0, 1, 2, 3]


@pytest.mark.parametrize("h,w,cw", [(32, 32, 2), (14, 14, 2), (6, 6, 2),
                                    (3, 2500, 8)])
def test_pool_rows_read_the_four_corners_of_their_window(h, w, cw):
    """The pooled band rows' staged offsets are the 2x2 corners of their
    window, and the odd trailing conv row and column are never read
    (31 -> 15, 13 -> 6, 5 -> 2), in whole rows and in column chunks."""
    trace = []
    rng = np.random.default_rng(h)
    a, wt, tau, flip = _case(rng, 1, h, w, 32 * cw, 32)
    emulate(a, wt, 32 * cw, tau=tau, flip=flip, pool=True, trace=trace)
    ho, wo = bcb.conv_out(h, w, True)
    t = bcb.conv_tiles(1, h, w, 32, cw, True)
    assert (t.chunks > 1) == (w > 1000)
    for bx, _, r, win, corner in trace:
        _, row0, col0, rows, cols = _band(t, bx, ho, wo)
        base, out = _row_of(np.array([r]), row0, col0, rows * cols, cols,
                            t.pitch, cw, wo, True)
        if out[0] < 0:
            continue
        y, x = divmod(int(base[0]), t.pitch)
        yo, xo = divmod(win, cols)
        assert (y, x // cw) == (2 * yo + (corner >> 1),
                                2 * xo + (corner & 1))
        assert 2 * (row0 + yo) + (corner >> 1) < 2 * ho
        assert 2 * (col0 + xo) + (corner & 1) < 2 * wo


def test_python_geometry_constants_match_the_kernels():
    """The two layout constants both sides know: warps a block and words a
    K step."""
    import re
    from pathlib import Path
    csrc = Path(bcb.__file__).resolve().parents[1] / "csrc"
    cuh = (csrc / "conv_mma.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(cuh, "kWarps") == bcb.WARPS
    assert const(cuh, "kStepWords") == bcb.STEP_WORDS


def test_wrappers_pass_the_geometry_to_the_c_entry_points():
    """The ctypes declarations carry every argument of the C entry points,
    pointers as c_void_p and ints as c_int, in order (the geometry
    included): a pointer passed as a 32-bit int would be cut."""
    import ctypes
    import re
    from pathlib import Path
    csrc = Path(bcb.__file__).resolve().parents[1] / "csrc"
    for name, argtypes in (("conv_block", bcb.ARGTYPES),
                           ("binary_conv2x2", bc.ARGTYPES)):
        src = (csrc / f"{name}.cu").read_text()
        sig = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)',
                        src).group(1)
        want = [ctypes.c_int if p.split()[0] == "int" else ctypes.c_void_p
                for p in sig.replace("\n", " ").split(",")]
        assert argtypes == want, name
