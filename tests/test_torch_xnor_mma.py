"""The tensor-core XNOR matmul (``csrc/xnor_matmul.cu``) and the sign+pack
kernels (``csrc/binarize_pack.cu``) emulated on the CPU.

``xnor_matmul``, int32 or packed, is a binary GEMM on ``mma.sync.m16n8k256
.b1 .and.popc``: rows are M, columns N, K runs over the packed words padded
with zero words to 256-bit steps, lane t of a quad holds a step's words 2t
and 2t + 1, and the XNOR count comes from the AND count by
``s = K - 2 (pa + pw - 2 popc(a & w))``.  No CUDA kernel runs here, so
:func:`emulate_xnor` repeats the kernel's arithmetic lane by lane at the
wrapper's own launch geometry (``xnor_tiles``): the staged chunks, each
warp's fragments as the MMA reads them, pa and pw from the loaded words,
the quad sums and shuffles, and the masked store, or for the packed
variant (``pack_out``, whose tiles take whole 32-column words) the sign
bits each lane holds, the quad's OR and one store a word.
``binarize_pack``'s two paths are emulated the same way: the flat path's float4 nibbles, shuffle
ORs and 16-byte word quads, the row path's ballots.  Both are held
bit-exact (tolerance 0) against the plain versions and against ``repro``'s
Pallas kernels in interpret mode, on numpy inputs from a seed; the launch
geometry is held to cover every output once and to fit shared memory.  The
kernels themselves are held against the plain versions on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binarize_pack as jbp
from repro.kernels import xnor_matmul as jxm
from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import binarize_pack as bp
from repro_torch.kernels import xnor_matmul as xm
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3
CSRC = Path(xm.__file__).resolve().parents[1] / "csrc"
BITLINEAR = (256, 2560, 960)            # tokens, d_out, d_in (SmolLM-360M)


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _popc(x) -> np.ndarray:
    return np.bitwise_count(np.asarray(x, dtype=np.uint32)).astype(np.int64)


def _quad_sum(v):
    v = v + v[LANES ^ 1]
    return v + v[LANES ^ 2]


def _mma_and_popc(r0, r1, r2, r3, b0, b1):
    """mma.m16n8k256 .b1 .and.popc on per-lane registers (PTX fragment
    layout): A row g holds bits 32t (r0) and 128 + 32t (r2) in lane 4g + t,
    row g + 8 the same from r1 and r3; B column g bits 32t (b0) and
    128 + 32t (b1).  Returns the accumulator increments (32, 4): rows g
    and g + 8 at columns 2t and 2t + 1."""
    a = np.zeros((16, 8), np.uint32)
    b = np.zeros((8, 8), np.uint32)
    a[G, T], a[G + 8, T], a[G, 4 + T], a[G + 8, 4 + T] = r0, r1, r2, r3
    b[G, T], b[G, 4 + T] = b0, b1
    d = _popc(a[:, None, :] & b[None, :, :]).sum(axis=-1)       # (16, 8)
    return np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T],
                     d[G + 8, 2 * T + 1]], axis=1)


def _stage(a, w, t, m0, n0, chunk):
    """stage_chunk: the block's bm A rows then bn W rows, words [chunk x
    kchunk x 8, + kchunk x 8) of each, kstride words apart; zeros past M
    (N) and past Kw."""
    (m, kw), n = a.shape, w.shape[0]
    buf = np.zeros((t.bm + t.bn, t.kstride), np.uint32)
    lo = chunk * t.kchunk * xm.STEP_WORDS
    hi = min(kw, lo + t.kchunk * xm.STEP_WORDS)
    if hi > lo:
        ra = a[m0:min(m, m0 + t.bm), lo:hi]
        rw = w[n0:min(n, n0 + t.bn), lo:hi]
        buf[:ra.shape[0], :hi - lo] = ra
        buf[t.bm:t.bm + rw.shape[0], :hi - lo] = rw
    return buf


def emulate_xnor(a, w, k, *, sms=xm.SMS, pack=False):
    """csrc/xnor_matmul.cu's kernel, lane by lane, on numpy words.

    a: (M, Kw) uint32, w: (N, Kw) uint32.  Returns (M, N) int64 sums, or
    with ``pack`` the (M, N / 32) uint32 sign words of the packed
    epilogue (each lane's 8 bits of a word, the quad's OR, lane t = 0's
    store); raises if an output is written twice or never."""
    (m, kw), n = a.shape, w.shape[0]
    t = xm.xnor_tiles(m, n, kw, sms, pack)
    shape = (m, n // 32) if pack else (m, n)
    out = np.zeros(shape, np.uint32 if pack else np.int64)
    writes = np.zeros(shape, np.int64)
    for by in range(t.grid[1]):
        for bx in range(t.grid[0]):
            m0, n0 = by * t.bm, bx * t.bn
            acc = np.zeros((xm.WARPS, t.tn, 32, 4), np.int64)
            pa = np.zeros((xm.WARPS, 2, 32), np.int64)
            pw = np.zeros((xm.WARPS, t.tn, 32), np.int64)
            for c in range(t.nchunks):
                buf = _stage(a, w, t, m0, n0, c)
                for warp in range(xm.WARPS):
                    wrow = (warp % t.wm) * 16
                    wcol = t.bm + (warp // t.wm) * 8 * t.tn
                    for s in range(t.kchunk):
                        kw0 = s * xm.STEP_WORDS + 2 * T
                        a0x, a0y = buf[wrow + G, kw0], buf[wrow + G, kw0 + 1]
                        a1x = buf[wrow + G + 8, kw0]
                        a1y = buf[wrow + G + 8, kw0 + 1]
                        pa[warp, 0] += _popc(a0x) + _popc(a0y)
                        pa[warp, 1] += _popc(a1x) + _popc(a1y)
                        for j in range(t.tn):
                            bx_, by_ = (buf[wcol + 8 * j + G, kw0],
                                        buf[wcol + 8 * j + G, kw0 + 1])
                            pw[warp, j] += _popc(bx_) + _popc(by_)
                            acc[warp, j] += _mma_and_popc(a0x, a1x, a0y,
                                                          a1y, bx_, by_)
            for warp in range(xm.WARPS):
                pa0, pa1 = _quad_sum(pa[warp, 0]), _quad_sum(pa[warp, 1])
                r0 = m0 + (warp % t.wm) * 16 + G
                wcol = n0 + (warp // t.wm) * 8 * t.tn
                bits = np.zeros((t.tn // 4 if pack else 0, 2, 32), np.uint32)
                for j in range(t.tn):
                    pwq = _quad_sum(pw[warp, j])
                    pw0, pw1 = pwq[8 * T], pwq[8 * T + 4]
                    col = wcol + 8 * j + 2 * T
                    and_ = acc[warp, j]
                    sums = {(0, 0): k - 2 * (pa0 + pw0 - 2 * and_[:, 0]),
                            (0, 1): k - 2 * (pa0 + pw1 - 2 * and_[:, 1]),
                            (8, 0): k - 2 * (pa1 + pw0 - 2 * and_[:, 2]),
                            (8, 1): k - 2 * (pa1 + pw1 - 2 * and_[:, 3])}
                    for (dr, dc), v in sums.items():
                        if pack:        # bit 8 (j % 4) + 2t + dc of word j / 4
                            sh = (8 * (j % 4) + 2 * T + dc).astype(np.uint32)
                            bits[j // 4, dr // 8] |= (v < 0).astype(
                                np.uint32) << sh
                            continue
                        r, cc = r0 + dr, col + dc
                        ok = (r < m) & (cc < n)
                        out[r[ok], cc[ok]] = v[ok]
                        np.add.at(writes, (r[ok], cc[ok]), 1)
                for wd in range(bits.shape[0]):
                    for i in range(2):
                        b = bits[wd, i]
                        b = b | b[LANES ^ 1]
                        b = b | b[LANES ^ 2]
                        r, cc = r0 + 8 * i, wcol + 32 * wd
                        ok = (T == 0) & (r < m)
                        if cc >= n:
                            continue
                        out[r[ok], cc // 32] = b[ok]
                        np.add.at(writes, (r[ok], cc // 32), 1)
    if not (writes == 1).all():
        raise AssertionError(f"outputs written {np.unique(writes)} times")
    return out


def _repro_xnor(a, w, k):
    return np.asarray(jxm.xnor_matmul(jnp.asarray(a), jnp.asarray(w), k=k,
                                      interpret=True)).astype(np.int64)


# ragged M (half an m16, one past it, several row tiles), N (inside one n8
# tile, odd, one past 32), K (one bit, one word, off the 256-bit grid, 50
# words in 4 chunks, 128 words in 8), random words with bits set past K
@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (8, 10, 1024), (8, 10, 64),
                                   (15, 33, 100), (17, 10, 31),
                                   (17, 1, 1600), (1, 33, 4096),
                                   (40, 72, 300)])
def test_xnor_emulation_vs_plain_and_repro(m, n, k):
    rng = np.random.default_rng(m * 1000 + n + k)
    kw = -(-k // 32)
    a, w = _words(rng, (m, kw)), _words(rng, (n, kw))
    got = emulate_xnor(a, w, k)
    plain = xm.xnor_matmul_plain(_i32(a), _i32(w), k).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _repro_xnor(a, w, k))


def test_xnor_emulation_at_several_row_blocks():
    """M=300 over five 64-row blocks, N=33 over three, K=1600 over two
    double-buffered chunks (50 words: the last chunk partly past Kw), and
    K=4096 over four."""
    rng = np.random.default_rng(300)
    a, w = _words(rng, (300, 50)), _words(rng, (33, 50))
    t = xm.xnor_tiles(300, 33, 50)
    assert t.grid[1] > 1 and t.grid[0] > 1 and t.nchunks == 2
    assert xm.xnor_tiles(300, 33, 128).nchunks == 4
    np.testing.assert_array_equal(
        emulate_xnor(a, w, 1600),
        xm.xnor_matmul_plain(_i32(a), _i32(w), 1600).numpy())


def _repro_xnor_pack(a, w, k):
    return np.asarray(jxm.xnor_matmul(jnp.asarray(a), jnp.asarray(w), k=k,
                                      pack_out=True, interpret=True))


# the packed variant: M at one row, one m16, one past it and the serve
# batch; N at one word, mnist5's two and BitLinear's 80; K at mnist5's 256,
# BitLinear's 960 and 100 (off the word and the 256-bit step)
@pytest.mark.parametrize("m", [1, 8, 17, 256])
@pytest.mark.parametrize("n", [32, 64, 2560])
@pytest.mark.parametrize("k", [256, 960, 100])
def test_xnor_pack_emulation_vs_plain_and_repro(m, n, k):
    rng = np.random.default_rng(7 * m + n + k)
    kw = -(-k // 32)
    a, w = _words(rng, (m, kw)), _words(rng, (n, kw))
    got = emulate_xnor(a, w, k, pack=True)
    plain = xm.xnor_matmul_plain(_i32(a), _i32(w), k,
                                 pack_out=True).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _repro_xnor_pack(a, w, k))


def test_xnor_identity_counts_bits_past_k_as_the_plain_version():
    """Words whose bits past K are all ones on one side and random on the
    other: the AND identity and the plain XOR count agree (K - 2 popc over
    every bit of the words, as repro computes it)."""
    rng = np.random.default_rng(5)
    a, w = _words(rng, (9, 4)), _words(rng, (11, 4))
    a[:, -1] |= np.uint32(0xffff0000)
    np.testing.assert_array_equal(
        emulate_xnor(a, w, 100),
        xm.xnor_matmul_plain(_i32(a), _i32(w), 100).numpy())
    np.testing.assert_array_equal(emulate_xnor(a, w, 100),
                                  _repro_xnor(a, w, 100))


# ---------------------------------------------------------------------------
# the launch geometry
# ---------------------------------------------------------------------------

def _fc_shapes():
    """(M, N, Kw) of every REGISTRY FC layer at the batches the serves and
    tests use, and BitLinear's."""
    shapes = {(BITLINEAR[0], BITLINEAR[1], BITLINEAR[2] // 32)}
    for name in networks.REGISTRY:
        for st in interpreter.compile_plan(networks.REGISTRY[name]()).mega:
            if st[0] == "fc":
                for batch in (1, 5, 8, 256):
                    shapes.add((batch, st[2], -(-st[1] // 32)))
    return sorted(shapes)


def _stores(t, m, n):
    """(row, column) of every int32 the kernel stores at geometry t, by
    walking its blocks, warps, n8 tiles and lanes."""
    rows, cols = [], []
    for by in range(t.grid[1]):
        for bx in range(t.grid[0]):
            for warp in range(xm.WARPS):
                r0 = by * t.bm + (warp % t.wm) * 16 + G
                c0 = bx * t.bn + (warp // t.wm) * 8 * t.tn + 2 * T
                for j in range(t.tn):
                    for dr in (0, 8):
                        for dc in (0, 1):
                            r, c = r0 + dr, c0 + 8 * j + dc
                            ok = (r < m) & (c < n)
                            rows.append(r[ok])
                            cols.append(c[ok])
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("m,n,kw", _fc_shapes())
def test_xnor_tiles_cover_every_output_once_and_fit(m, n, kw):
    t = xm.xnor_tiles(m, n, kw)
    assert t.smem <= xm.SMEM_DEFAULT
    assert t.smem == 4 * (2 if t.nchunks > 1 else 1) * (t.bm + t.bn) \
        * t.kstride
    assert t.kstride % 16 == 8 and t.kstride >= 8 * t.kchunk
    assert t.kchunk in (1, 2, 4)               # the staging's shift
    assert t.kchunk * t.nchunks * 8 >= kw > (t.nchunks - 1) * t.kchunk * 8
    assert t.wm * t.wn == xm.WARPS and t.tn in xm.WARP_TILES
    assert 16 * (t.wm - 1) < m                 # no warp row wholly past M
    r, c = _stores(t, m, n)
    counts = np.zeros((m, n), np.int64)
    np.add.at(counts, (r, c), 1)
    assert (counts == 1).all()


def _pack_shapes():
    """(M, N, Kw) of every REGISTRY FC layer with whole words of N (the
    packed variant's) at the serves' batches, and the packed tests'."""
    shapes = {(m, n, kw) for m, n, kw in _fc_shapes() if n % 32 == 0}
    shapes |= {(m, n, -(-k // 32)) for m in (1, 8, 17, 256)
               for n in (32, 64, 2560) for k in (256, 960, 100)}
    return sorted(shapes)


def _word_stores(t, m, n):
    """(row, word) of every word the packed epilogue stores at geometry
    t: lane t = 0 of each quad, rows g and g + 8, a word a 32 columns of
    the warp's strip."""
    rows, cols = [], []
    for by in range(t.grid[1]):
        for bx in range(t.grid[0]):
            for warp in range(xm.WARPS):
                r0 = by * t.bm + (warp % t.wm) * 16 + G[T == 0]
                c0 = bx * t.bn + (warp // t.wm) * 8 * t.tn
                assert c0 % 32 == 0
                for wd in range(t.tn // 4):
                    for dr in (0, 8):
                        r = r0 + dr
                        ok = (r < m) & (c0 + 32 * wd < n)
                        rows.append(r[ok])
                        cols.append(np.full(ok.sum(), (c0 + 32 * wd) // 32))
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("m,n,kw", _pack_shapes())
def test_xnor_pack_tiles_take_whole_words_and_cover_each_once(m, n, kw):
    t = xm.xnor_tiles(m, n, kw, pack=True)
    assert t.tn in xm.PACK_WARP_TILES and t.bn % 32 == 0
    assert t.smem <= xm.SMEM_DEFAULT and t.wm * t.wn == xm.WARPS
    r, c = _word_stores(t, m, n)
    counts = np.zeros((m, n // 32), np.int64)
    np.add.at(counts, (r, c), 1)
    assert (counts == 1).all()


def test_xnor_pack_tiles_break_ties_toward_more_blocks():
    """At BitLinear's shape the packed tiles of equal work on the busiest
    SM and over all blocks are 80 blocks of 64 x 128 and 160 of 64 x 64:
    the packed variant takes the 160 (the int32 variant's tie-break, the
    fewest blocks, is unchanged: 64 x 80 there).  At mnist5's hidden
    layer at the serve batch (N = 64) the 16 x 256 tiles overhang N by
    four times: 4 blocks of 64 x 64."""
    t = xm.xnor_tiles(BITLINEAR[0], BITLINEAR[1], BITLINEAR[2] // 32,
                      pack=True)
    assert (t.bm, t.bn, t.tn) == (64, 64, 4) and t.grid == (40, 4)
    assert xm.xnor_tiles(8, 64, 8, pack=True).bn == 256      # one block
    t = xm.xnor_tiles(256, 64, 8, pack=True)
    assert (t.bm, t.bn) == (64, 64) and t.grid == (1, 4)


def test_xnor_tiles_fill_the_card_in_one_wave_at_bitlinear():
    """256 x 2560: 64 x 80 tiles, 128 blocks, none on a second wave; M <= 16
    is one block along M."""
    t = xm.xnor_tiles(BITLINEAR[0], BITLINEAR[1], BITLINEAR[2] // 32)
    assert (t.bm, t.bn) == (64, 80) and t.grid == (32, 4)
    assert t.grid[0] * t.grid[1] <= xm.SMS
    assert t.nchunks == 1                     # K=960: 4 steps, one chunk
    for m in (1, 8, 15, 16):
        assert xm.xnor_tiles(m, 10, 32).grid[1] == 1


def test_copy_words_divide_kw_and_keep_alignment():
    for kw in (1, 2, 3, 4, 30, 32, 50, 128):
        for pa_, pw_ in ((0, 0), (4, 0), (8, 16), (16, 32)):
            cpw = xm.copy_words(kw, pa_, pw_)
            assert kw % cpw == 0 and pa_ % (4 * cpw) == 0 \
                and pw_ % (4 * cpw) == 0
    assert xm.copy_words(30, 0, 0) == 2 and xm.copy_words(32, 0, 0) == 4
    assert xm.copy_words(32, 4, 0) == 1


# ---------------------------------------------------------------------------
# binarize_pack's two paths
# ---------------------------------------------------------------------------

def _nibble(f):
    neg = (f < 0).astype(np.uint32)          # NaN and -0.0 compare False
    return neg[:, 0] | neg[:, 1] << 1 | neg[:, 2] << 2 | neg[:, 3] << 3


def emulate_pack_flat(x, *, sms=bp.SMS):
    """binarize_pack_flat_kernel, lane by lane: (M, K) float32, K % 32 ==
    0 -> (M, K/32) uint32 words; raises unless each word is stored once."""
    m, k = x.shape
    flat = x.reshape(-1, 4)
    nvec = flat.shape[0]
    words = nvec // 8
    out = np.zeros(words, np.uint32)
    writes = np.zeros(words, np.int64)
    nwarps = bp.pack_blocks(m, k, True, sms) * bp.WARPS
    for warp in range(nwarps):
        for tile in range(warp, -(-nvec // (32 * bp.CHUNKS)), nwarps):
            word = []
            for u in range(bp.CHUNKS):
                v = tile * 32 * bp.CHUNKS + 32 * u + LANES
                f = np.where((v < nvec)[:, None],
                             flat[np.minimum(v, nvec - 1)], 1.0)
                b = _nibble(f) << (4 * (LANES & 7)).astype(np.uint32)
                for mask in (1, 2, 4):
                    b = b | b[LANES ^ mask]
                word.append(b)
            q = LANES & 3
            mine = np.choose(q, word)          # lane 8j + i offers word i & 3
            quad = np.stack([mine[8 * j + q] for j in range(4)], axis=1)
            for lane in range(bp.CHUNKS):
                w0 = tile * 4 * bp.CHUNKS + 4 * lane
                for j in range(4):
                    if w0 + j < words:
                        out[w0 + j] = quad[lane, j]
                        writes[w0 + j] += 1
    assert (writes == 1).all()
    return out.reshape(m, k // 32)


def emulate_pack_rows(x, *, sms=bp.SMS):
    """binarize_pack_rows_kernel, lane by lane: one row's CHUNKS words a
    warp, lane l's float 32 w + l (masked past K) into word w's ballot."""
    m, k = x.shape
    kw = -(-k // 32)
    spans = -(-kw // bp.CHUNKS)
    out = np.zeros((m, kw), np.uint32)
    writes = np.zeros((m, kw), np.int64)
    nwarps = bp.pack_blocks(m, k, False, sms) * bp.WARPS
    for warp in range(nwarps):
        for item in range(warp, m * spans, nwarps):
            row, span = divmod(item, spans)
            wd0 = span * bp.CHUNKS
            for u in range(bp.CHUNKS):
                col = (wd0 + u) * 32 + LANES
                neg = (col < k) & (x[row, np.minimum(col, k - 1)] < 0)
                ballot = np.uint32((neg.astype(np.uint64)
                                   << LANES.astype(np.uint64)).sum())
                if wd0 + u < kw:                 # stored by lane u
                    out[row, wd0 + u] = ballot
                    writes[row, wd0 + u] += 1
    assert (writes == 1).all()
    return out


def _pack_input(rng, m, k):
    x = rng.standard_normal((m, k)).astype(np.float32)
    flat = x.reshape(-1)
    special = np.array([0.0, -0.0, np.nan, 1e-30, -1e-30, -np.nan, -np.inf,
                        np.inf], np.float32)
    flat[:min(8, flat.size)] = special[:min(8, flat.size)]
    flat[-1] = -0.0
    return x


@pytest.mark.parametrize("m,k", [(1, 1), (1, 100), (1, 960), (3, 100),
                                 (256, 960), (7, 32), (300, 100),
                                 (5, 4096)])
def test_pack_emulation_vs_plain_and_repro(m, k):
    """Both paths (the flat one where K % 32 == 0) against the plain
    version and repro's Pallas kernel in interpret mode, with 0.0, -0.0,
    NaN of both signs, +/-1e-30 and +/-inf: bit 1 iff x < 0."""
    x = _pack_input(np.random.default_rng(m + k), m, k)
    plain = bp.binarize_pack_plain(torch.from_numpy(x)).numpy().view(
        np.uint32)
    repro = np.asarray(jbp.binarize_pack(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(plain, repro)
    np.testing.assert_array_equal(emulate_pack_rows(x), plain)
    if k % 32 == 0:
        np.testing.assert_array_equal(emulate_pack_flat(x), plain)


def test_pack_flat_emulation_loops_over_the_grid():
    """A grid of fewer warps than tiles (two SMs' worth) and a last tile
    cut inside a chunk: every word once, equal to the plain version."""
    x = _pack_input(np.random.default_rng(9), 8 * 31 * 31, 256)[:2500]
    plain = bp.binarize_pack_plain(torch.from_numpy(x)).numpy().view(
        np.uint32)
    assert bp.pack_blocks(2500, 256, True, 2) * bp.WARPS * 512 < x.size
    np.testing.assert_array_equal(emulate_pack_flat(x, sms=2), plain)
    np.testing.assert_array_equal(emulate_pack_rows(x, sms=2), plain)


def test_pack_path_takes_k_and_alignment_alone():
    assert bp.pack_path(960, 0) and bp.pack_path(256, 4096)
    assert not bp.pack_path(960, 4) and not bp.pack_path(100, 0)
    assert not bp.pack_path(1, 0)
    assert bp.pack_blocks(256, 960, True) == 60           # 480 tiles
    assert bp.pack_blocks(8 * 31 * 31, 256, True) == 481
    assert bp.pack_blocks(10 ** 6, 960, True) == bp.SMS * bp.BLOCKS_PER_SM


# ---------------------------------------------------------------------------
# the Python side of the C entry points
# ---------------------------------------------------------------------------

def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_geometry_constants_match_the_kernels():
    xsrc = (CSRC / "xnor_matmul.cu").read_text()
    assert _const(xsrc, "kWarps") == xm.WARPS
    assert _const((CSRC / "conv_mma.cuh").read_text(),
                  "kStepWords") == xm.STEP_WORDS
    for pack, tiles in ((False, xm.WARP_TILES), (True, xm.PACK_WARP_TILES)):
        cases = sorted(int(c) for c in re.findall(
            rf"case (\d+): launch_mma<\1, {str(pack).lower()}>", xsrc))
        assert tuple(cases) == tiles
    # one kernel design: the CUDA-core pack kernel is gone
    assert re.findall(r"__global__ void (?:__launch_bounds__\(\w+\)\s+)?"
                      r"(\w+)\(", xsrc) == ["xnor_mma_kernel"]
    psrc = (CSRC / "binarize_pack.cu").read_text()
    assert _const(psrc, "kWarps") == bp.WARPS
    assert _const(psrc, "kChunks") == bp.CHUNKS


def test_wrappers_pass_every_argument_to_the_c_entry_points():
    """The ctypes declarations carry every argument of the C entry points,
    pointers as c_void_p and ints as c_int, in order."""
    for name, argtypes in (("xnor_matmul", xm.ARGTYPES),
                           ("binarize_pack", bp.ARGTYPES)):
        src = (CSRC / f"{name}.cu").read_text()
        sig = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)',
                        src).group(1)
        want = [ctypes.c_int if p.split()[0] == "int" else ctypes.c_void_p
                for p in sig.replace("\n", " ").split(",")]
        assert argtypes == want, name
    t = xm.xnor_tiles(*BITLINEAR[:2], BITLINEAR[2] // 32)
    # m, n, kw, k, pack_out, the geometry, copy width, grid and smem
    assert 5 + len(t.args) + 1 + len(t.grid) + 1 == \
        xm.ARGTYPES.count(ctypes.c_int)
