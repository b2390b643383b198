"""The cluster member body (``csrc/member_mma.cuh``) emulated on the CPU.

The composite megakernel (``csrc/megakernel.cu``) and the delta gate's
recompute (``csrc/delta.cu``) run one frame on one thread-block cluster:
rank r computes a band of each conv layer's output rows, every column and
feature, with ``conv_mma.cuh``'s binary implicit GEMM and fused epilogue on
its own copy of the map, and stores each word also to the ranks whose next
layer reads its row (the halo rows); it packs the input rows its first
layer reads, a warp at one channel word; the FC tail gives rank r the
32-output chunks r, r + cluster, ... on the whole final map.  No CUDA
kernel runs here, so :func:`emulate_frame` repeats that arithmetic lane by
lane and rank by rank at the wrapper's own geometry
(``cluster_geometry``): the staged taps, each warp's tiles and their MMA
fragments, the epilogue's shuffles, every local and remote store.  It
raises if an output word is written other than once or a rank reads a
word it does not hold, and it is held bit-exact (tolerance 0) against
``megakernel_plain`` and ``composite_plain`` at every REGISTRY program and
at a composite that mixes S=2 and S=4 members; the delta gate's split pack
and partial sums (``gate_geometry``) against the plain packed words and
deltas.  The kernels themselves are held against the plain versions on the
card by ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.binarize import thermometer_pack
from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import megakernel as mk
from repro_torch.launch.chip_serve import frame_stream
from tests.test_torch_conv_mma import (G, LANES, T, _popc, _quad_sum,
                                       _row_of, _shfl_xor)
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401

CSRC = Path(mk.__file__).resolve().parents[1] / "csrc"
PROGRAMS = sorted(networks.REGISTRY)
MIXED = ("cifar9_s2", "mnist5", "face_detector")     # S=2 beside two S=4
ONES = np.uint32(0xFFFFFFFF)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _ballot(bits) -> np.ndarray:
    """(..., 32) lane predicates -> (...) uint32 words, lane 0 on bit 0."""
    return (np.asarray(bits, np.uint64) << LANES.astype(np.uint64)).sum(
        axis=-1).astype(np.uint32)


def _random_image(prog, seed):
    gen = torch.Generator().manual_seed(seed)
    params = interpreter.init_params(gen, prog, device="cpu")
    for p in params["conv"]:
        f = p["gamma"].shape[0]
        p["gamma"] = torch.randn(f, generator=gen)
        p["beta"] = torch.randn(f, generator=gen) * 4
        p["mean"] = torch.randn(f, generator=gen) * 16
        p["var"] = torch.rand(f, generator=gen) * 100 + 1
    return interpreter.fold_params(params, prog, image=True)


class RankMap:
    """One rank's map buffer: its words, which of them hold data (the rows
    the rank wrote, packed, loaded or was sent), and the stores into each."""

    def __init__(self, words):
        self.words = np.zeros(words, np.uint32)
        self.valid = np.zeros(words, bool)
        self.writes = np.zeros(words, np.int64)

    def store(self, slot, word):
        self.words[slot] = word
        self.valid[slot] = True
        self.writes[slot] += 1

    def read(self, idx):
        if not self.valid[idx].all():
            raise AssertionError("a rank read a word it does not hold")
        return self.words[idx]


def layer_reads(stages, l, r, n):
    """member_mma.cuh layer_reads: the input rows rank r reads at conv
    layer l (its band's rows, one more below, two with the pool)."""
    _, ch, _w, _c, _f, pool, _off = mk._split_stages(stages)[0][1 + l]
    ho = (ch - 1) // 2 if pool else ch - 1
    return mk.rows_read(mk.band_start(ho, r, n), mk.band_start(ho, r + 1, n),
                        pool)


def pack_rank(stages, frame, thr, pos0, pos1):
    """member_mma.cuh pack_positions on one rank's (or gate block's)
    positions: [(pos, channel word, word)] in the order the warps emit
    them."""
    _, _h, _w, cin, _bits, channels = stages[0]
    cwio, per = channels // 32, channels // cin
    pix = frame.reshape(-1, cin)
    active = mk.CLUSTER_WARPS - mk.CLUSTER_WARPS % cwio
    out = []
    for warp in range(active):
        cwi = warp % cwio
        ch = cwi * 32 + LANES
        valid = ch < cin * per
        c = np.where(valid, ch // per, 0)
        t = np.where(valid, thr[np.where(valid, ch - c * per, 0)],
                     np.float32(0))
        pos = np.arange(pos0 + warp // cwio, pos1, active // cwio)
        bits = valid & (pix[pos][:, c].astype(np.float32) < t)
        out += [(int(p), cwi, w) for p, w in zip(pos, _ballot(bits))]
    return out


def stage_taps(cw_img, l, row0, f, cw, ksteps, kstride):
    """member_mma.cuh stage_layer: F feature rows of kstride words, the
    4 Cw tap words then zeros."""
    assert 8 * ksteps >= 4 * cw and 8 * ksteps <= kstride
    sb = np.zeros((f, kstride), np.uint32)
    sb[:, :4 * cw] = cw_img[l, row0:row0 + f, :, :cw].reshape(f, -1)
    return sb


def conv_band(cur, sb, tau, flip, c, h, wd, pool, fwo, rank, cluster,
              ksteps, maps, readers):
    """member_mma.cuh conv_band / band_tiles for one rank: its band of
    output rows, warp w on feature slice w % fwo and every (16 / fwo)-th
    m16 tile, the slice's B fragments held for the layer (pw from all-ones
    A rows), the A fragments read from the rank's own map in place (pa
    from an all-ones B column), the fused epilogue, each word stored to the
    rank's next map and to every rank in ``readers`` (rank -> rows) that
    reads its row."""
    cw = c // 32
    pitch = wd * cw
    ho, wo = ((h - 1) // 2, (wd - 1) // 2) if pool else (h - 1, wd - 1)
    o0, o1 = mk.band_start(ho, rank, cluster), mk.band_start(ho, rank + 1,
                                                             cluster)
    windows = (o1 - o0) * wo
    if windows <= 0:
        return
    tiles = -(-(4 * windows if pool else windows) // 16)
    sa0 = mk.rows_read(o0, o1, pool)[0] * pitch
    shift = (8 * np.arange(4)[None, :, None] + 2 * T[:, None, None]
             + np.arange(2)[None, None, :])                  # (32, 4, 2)
    for warp in range(mk.CLUSTER_WARPS):
        slice_ = warp % fwo
        mts = np.arange(warp // fwo, tiles, mk.CLUSTER_WARPS // fwo)
        if not len(mts):
            continue
        bw = sb[32 * slice_:32 * slice_ + 32]
        th = tau[32 * slice_ + shift].astype(np.int64)
        flb = flip[32 * slice_ + shift].astype(np.int64) & 1
        # B fragments: lane (g, t) holds column g of n8 tile j, words 2t and
        # 2t + 1 of each step; pw from all-ones A rows on them
        pw = np.zeros((32, 4, 2), np.int64)
        for s in range(ksteps):
            kw = 8 * s + 2 * T
            assert (kw + 1 < 8 * ksteps).all()
            for j in range(4):
                brow = 8 * j + G
                ones = (_popc(ONES & bw[brow, kw].reshape(8, 4))
                        + _popc(ONES & bw[brow, kw + 1].reshape(8, 4))
                        ).sum(-1)                          # column n
                pw[:, j, 0] += ones[2 * T]
                pw[:, j, 1] += ones[2 * T + 1]
        kc = 4 * c - 2 * pw                                   # (32, 4, 2)
        rows = 16 * mts[:, None] + G[None, :]                 # (nt, 32)
        base0, out0 = _row_of(rows, o0, 0, windows, wo, pitch, cw, wo, pool)
        base1, out1 = _row_of(rows + 8, o0, 0, windows, wo, pitch, cw, wo,
                              pool)
        nt = len(mts)
        acc = np.zeros((nt, 32, 4, 4), np.int64)
        pa = np.zeros((nt, 32, 4), np.int64)      # an all-ones B column
        for s in range(ksteps):
            kw = 8 * s + 2 * T
            valid = kw < 4 * cw
            off = kw + (kw >= 2 * cw) * (pitch - 2 * cw)
            frag = []
            for base, out in ((base0, out0), (base1, out1)):
                # padding rows (out -1) compute on word 0 and store nothing
                live = valid & (out >= 0)
                idx = np.where(live, sa0 + base + off, 0)
                lo, hi = np.zeros(idx.shape, np.uint32), np.zeros(
                    idx.shape, np.uint32)
                lo[live], hi[live] = cur.read(idx[live]), cur.read(
                    idx[live] + 1)
                frag.append((lo, hi))
            (a0x, a0y), (a1x, a1y) = frag
            # A rows 0-7 from a0 of lanes (g, t), rows 8-15 from a1
            alo = np.concatenate([a0x.reshape(nt, 8, 4),
                                  a1x.reshape(nt, 8, 4)], axis=1)
            ahi = np.concatenate([a0y.reshape(nt, 8, 4),
                                  a1y.reshape(nt, 8, 4)], axis=1)
            row_ones = (_popc(alo & ONES) + _popc(ahi & ONES)).sum(-1)
            pa[:, :, 0] += row_ones[:, G]
            pa[:, :, 2] += row_ones[:, G + 8]
            for j in range(4):
                brow = 8 * j + G
                blo = bw[brow, kw].reshape(8, 4)
                bhi = bw[brow, kw + 1].reshape(8, 4)
                prod = (_popc(alo[:, :, None, :] & blo[None, None])
                        + _popc(ahi[:, :, None, :] & bhi[None, None])
                        ).sum(axis=-1)                      # (nt, 16, 8)
                acc[:, :, j, 0] += prod[:, G, 2 * T]
                acc[:, :, j, 1] += prod[:, G, 2 * T + 1]
                acc[:, :, j, 2] += prod[:, G + 8, 2 * T]
                acc[:, :, j, 3] += prod[:, G + 8, 2 * T + 1]
        s0 = kc[None] - 2 * pa[:, :, 0, None, None] + 4 * acc[..., 0:2]
        s1 = kc[None] - 2 * pa[:, :, 2, None, None] + 4 * acc[..., 2:4]
        w0 = (((s0 >= th) ^ flb ^ 1) << shift).sum(axis=(2, 3))  # (nt, 32)
        w1 = (((s1 >= th) ^ flb ^ 1) << shift).sum(axis=(2, 3))
        for i in range(nt):
            x0, x1 = w0[i], w1[i]
            if pool:
                x0 = x0 & x1
                x0 = x0 & _shfl_xor(x0, 16)
            for m in (1, 2):
                x0 = x0 | _shfl_xor(x0, m)
                x1 = x1 | _shfl_xor(x1, m)
            for lane in np.flatnonzero(T == 0):
                if pool and G[lane] >= 4:
                    continue
                stores = ([(out0[i, lane], x0[lane])] if pool else
                          [(out0[i, lane], x0[lane]),
                           (out1[i, lane], x1[lane])])
                for out, word in stores:
                    if out < 0:
                        continue
                    y = out // wo
                    assert o0 <= y < o1
                    maps[rank].store(out * fwo + slice_, word)
                    for q, (first, last) in readers.items():
                        if q != rank and first <= y < last:
                            maps[q].store(out * fwo + slice_, word)


def emulate_frame(stages, m, image, frame, geo, words=None):
    """One frame of member m through the cluster body at geometry geo
    (``cluster_geometry`` of the launch's spec): (classes,) int64 logits.
    ``words`` (H, W, cwio) uint32: the recompute's input (the gate's
    words), else each rank packs the pixels of the rows it reads."""
    cluster = geo.cluster
    head, tail = mk._split_stages(stages)
    _, h, w, cin, bits, channels = head[0]
    cwio = channels // 32
    cw_img = _u32(image["cw"])
    ct, cf = image["ct"].numpy(), image["cf"].numpy()
    fw_img = _u32(image["fw"])
    thr = mk._member_thresholds(stages, "cpu").numpy()
    cur = [RankMap(geo.map_words) for _ in range(cluster)]
    for rank in range(cluster):
        first, last = (layer_reads(stages, 0, rank, cluster)
                       if len(head) > 1 else (0, h))
        if words is not None:
            idx = np.arange(first * w * cwio, last * w * cwio)
            cur[rank].words[idx] = words.reshape(-1)[idx]
            cur[rank].valid[idx] = True
            continue
        assert (last - first) * w * cin + 3 <= geo.pix_words
        for pos, cwi, word in pack_rank(stages, frame, thr, first * w,
                                        last * w):
            cur[rank].store(pos * cwio + cwi, word)
        span = slice(first * w * cwio, last * w * cwio)
        assert (cur[rank].writes[span] == 1).all(), "pack"
    n_chunks = -(-tail[0][2] // 32)
    for l, (_, ch, cwd, c, f, pool, f_off) in enumerate(head[1:]):
        fwo = f // 32
        ho, wo = ((ch - 1) // 2, (cwd - 1) // 2) if pool else (ch - 1,
                                                              cwd - 1)
        last_layer = l + 2 == len(head)
        # the rows each rank reads next: its next layer's, or all of them
        # at the FC tail's ranks
        readers = {q: ((0, ho) if q < n_chunks else (0, 0)) if last_layer
                   else layer_reads(stages, l + 1, q, cluster)
                   for q in range(cluster)}
        nxt = [RankMap(geo.map_words) for _ in range(cluster)]
        sb = stage_taps(cw_img, l, f_off, f, c // 32, geo.ksteps[m][l],
                        geo.kstride)
        for r in range(cluster):
            conv_band(cur[r], sb, ct[l, f_off:f_off + f],
                      cf[l, f_off:f_off + f], c, ch, cwd, pool, fwo, r,
                      cluster, geo.ksteps[m][l], nxt, readers)
        # each rank holds the rows it reads next, every word written once
        for q, (first, last) in readers.items():
            own = (mk.band_start(ho, q, cluster),
                   mk.band_start(ho, q + 1, cluster))
            for y in range(min(first, own[0]), max(last, own[1])):
                if not (first <= y < last or own[0] <= y < own[1]):
                    continue
                span = slice(y * wo * fwo, (y + 1) * wo * fwo)
                assert (nxt[q].writes[span] == 1).all(), (l, q, y)
        cur = nxt
    out = np.zeros(tail[-1][2], np.int64)
    written = np.zeros(tail[-1][2], np.int64)
    for fi, (_, k, n, final, _pack, n_off) in enumerate(tail):
        kw = -(-k // 32)
        nxt = [RankMap(geo.map_words) for _ in range(cluster)]
        for rank in range(cluster):
            for warp in range(mk.CLUSTER_WARPS):
                for chunk in range(rank + cluster * warp, -(-n // 32),
                                   cluster * mk.CLUSTER_WARPS):
                    nn = chunk * 32 + LANES
                    ok = nn < n
                    rows = fw_img[fi, n_off + np.where(ok, nn, 0), :kw]
                    x = cur[rank].read(np.arange(kw))
                    s = k - 2 * _popc(x[None, :] ^ rows).sum(axis=1)
                    if final:
                        out[nn[ok]] = s[ok]
                        written[nn[ok]] += 1
                    else:
                        word = _ballot(ok & (s < 0))
                        for lane in range(cluster):   # lane k to rank k
                            nxt[lane].store(chunk, word)
        if not final:
            for r in nxt:
                assert (r.writes[:-(-n // 32)] == 1).all(), f"fc {fi}"
            cur = nxt
    assert (written == 1).all()
    return out


def _member_case(name, b, seed):
    prog = networks.REGISTRY[name]()
    mega = interpreter.compile_plan(prog).mega
    frames = torch.from_numpy(frame_stream(prog, b, seed))
    return prog, mega, frames, _random_image(prog, seed)


@pytest.mark.parametrize("name", PROGRAMS)
def test_emulated_cluster_body_matches_plain_at_every_program(name):
    """Every REGISTRY program (two frames; one at S=1), at its own cluster
    geometry: the emulated body equals megakernel_plain, and the
    recompute's path from the packed words equals it too."""
    b = 1 if name in ("cifar9_s1", "owner_detector") else 2
    prog, mega, frames, image = _member_case(name, b, 5)
    spec = mk.solo_member_spec(mega)
    geo = mk.cluster_geometry(spec)
    want = mk.megakernel_plain(image, frames, spec=mega).numpy()
    io = mega[0]
    words = _u32(thermometer_pack(frames, io[4], io[3], io[5]))
    for i in range(b):
        got = emulate_frame(spec[0], 0, image, frames[i].numpy(), geo)
        np.testing.assert_array_equal(got, want[i])
    np.testing.assert_array_equal(
        emulate_frame(spec[0], 0, image, None, geo, words=words[0]), want[0])


def test_emulated_mixed_composite_matches_plain():
    """cifar9_s2 (4 feature words) beside mnist5 and face_detector (2):
    one cluster of 4 for all three, each splitting its rows over the 4
    ranks, ragged batches; each member equals composite_plain."""
    progs = {n: networks.REGISTRY[n]() for n in MIXED}
    images = {n: _random_image(p, 10 + i)
              for i, (n, p) in enumerate(progs.items())}
    cplan, cimage = interpreter.pack_programs(progs, images)
    geo = mk.cluster_geometry(cplan.spec)
    assert geo.cluster == 4
    frames = [torch.from_numpy(frame_stream(progs[n], b, 30 + b))
              for n, b in zip(MIXED, (1, 2, 1))]
    want = mk.composite_plain(cimage, frames, spec=cplan.spec)
    for m, (stages, f, wm) in enumerate(zip(cplan.spec, frames, want)):
        for i in range(f.shape[0]):
            got = emulate_frame(stages, m, cimage, f[i].numpy(), geo)
            np.testing.assert_array_equal(got, wm[i].numpy())


@pytest.mark.parametrize("name", ["cifar9_s1", "cifar9_s4", "mnist5"])
def test_gate_split_pack_and_partials_match_plain(name):
    """gate_kernel's blocks cover the frame's positions once; their packed
    words are thermometer_pack's and their partial popcounts sum to
    delta_plain's deltas."""
    b = 3
    prog, mega, frames, image = _member_case(name, b, 9)
    io = mega[0]
    spec = mk.solo_member_spec(mega)
    gate = mk.gate_geometry(spec[0])
    want_words = _u32(thermometer_pack(frames, io[4], io[3], io[5]))
    prev = frames.clone()
    prev[:, :4, :4] = (prev[:, :4, :4] + 2 ** io[4] // 2) % 2 ** io[4]
    last = thermometer_pack(prev, io[4], io[3], io[5])
    plan, dimage = interpreter.pack_delta(prog, image)
    ctrl = plan.delta_ctrl(0.0, b)
    llog = torch.zeros((b, plan.classes), dtype=torch.int32)
    deltas = mk.delta_plain(dimage, frames, last, llog, ctrl,
                            spec=plan.spec)[4].numpy()
    thr = mk._member_thresholds(spec[0], "cpu").numpy()
    hw, cwio = io[1] * io[2], io[5] // 32
    assert gate.cur_stride >= hw * cwio and gate.cur_stride % 4 == 0
    for i in range(b):
        cur = np.zeros(gate.cur_stride, np.uint32)
        seen = np.zeros(hw * cwio, np.int64)
        total = 0
        lw = _u32(last[i]).reshape(-1)
        for g in range(gate.blocks):
            pos0, pos1 = hw * g // gate.blocks, hw * (g + 1) // gate.blocks
            assert (pos1 - pos0) * io[3] + 3 <= gate.pix_words
            assert 4 * (gate.pix_words + _round4((pos1 - pos0) * cwio + 3)
                        ) <= gate.smem
            for pos, cwi, word in pack_rank(spec[0], frames[i].numpy(), thr,
                                            pos0, pos1):
                cur[pos * cwio + cwi] = word
                seen[pos * cwio + cwi] += 1
                total += int(_popc(word ^ lw[pos * cwio + cwi]))
        assert (seen == 1).all()
        np.testing.assert_array_equal(cur[:hw * cwio],
                                      want_words[i].reshape(-1))
        assert total == deltas[i]


def _round4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("name", PROGRAMS)
def test_cluster_geometry_fits_and_covers(name):
    """At every program: a cluster of F/32 blocks, shared memory within
    227 KB and as parse_geometry computes it, every rank's pixel rows and
    every layer's row readers inside the staging buffer, and each layer's
    output rows split into bands that cover them once."""
    prog = networks.REGISTRY[name]()
    spec = mk.solo_member_spec(interpreter.compile_plan(prog).mega)
    geo = mk.cluster_geometry(spec)
    head, _ = mk._split_stages(spec[0])
    _, h, w, cin, _bits, channels = head[0]
    n = geo.cluster
    assert n == max(st[4] // 32 for st in head[1:])
    assert geo.smem <= mk.SMEM_LIMIT
    assert geo.smem == 4 * (2 * geo.map_words + 2 * geo.fmax
                            * (geo.kstride + 2) + geo.pix_words)
    assert geo.kstride % 16 == 8 and geo.map_words % 4 == 0
    assert geo.map_words >= h * w * channels // 32
    for rank in range(n):
        first, last = layer_reads(spec[0], 0, rank, n)
        assert 0 <= first <= last <= h
        assert (last - first) * w * cin + 3 <= geo.pix_words
    for l, (_, ch, cwd, c, f, pool, _off) in enumerate(head[1:]):
        assert 4 * c // 32 <= 8 * geo.ksteps[0][l] <= geo.kstride
        assert f <= geo.fmax and mk.CLUSTER_WARPS % (f // 32) == 0
        ho = (ch - 1) // 2 if pool else ch - 1
        assert ho <= geo.pix_words          # a readers word a row
        rows = [y for r in range(n) for y in range(
            mk.band_start(ho, r, n), mk.band_start(ho, r + 1, n))]
        assert rows == list(range(ho))
        for r in range(n):                # the rows a band reads exist
            assert layer_reads(spec[0], l, r, n)[1] <= ch


def _stages(convs, io=(32, 32, 3, 7, 256), fc=((1024, 10),)):
    st = [("io",) + io]
    st += [("conv",) + cv + (0,) for cv in convs]
    st += [("fc", k, n, i == len(fc) - 1, i < len(fc) - 1, 0)
           for i, (k, n) in enumerate(fc)]
    return tuple(st)


def test_cluster_geometry_raises_on_specs_it_cannot_take():
    ok = _stages([(32, 32, 256, 256, False)])
    assert mk.cluster_geometry((ok,)).cluster == 8
    assert mk.cluster_geometry(
        (_stages([(32, 32, 256, 64, False)]),)).cluster == 2
    bad = {
        "512 features: a cluster of 16": (_stages(
            [(32, 32, 256, 512, False)]),),
        "96 features: 3 slices do not divide 8 warps": (
            _stages([(32, 32, 256, 96, False)]),),
        "F not a multiple of 32": (_stages([(32, 32, 256, 40, False)]),),
        "C past 256": (_stages([(32, 32, 288, 256, False)],
                               io=(32, 32, 3, 7, 288)),),
        "maps past shared memory": (_stages([(64, 64, 256, 256, False)],
                                            io=(64, 64, 3, 7, 256)),),
    }
    for what, spec in bad.items():
        with pytest.raises(ValueError):
            mk.cluster_geometry(spec)
            pytest.fail(what)


def _signature(src, name):
    """The ctypes of a C entry point's parameters, read from its source:
    ``void**`` arrays, ``int*`` arrays, other pointers, ints."""
    text = (CSRC / f"{src}.cu").read_text()
    sig = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)',
                    text).group(1)
    types = []
    for p in sig.replace("\n", " ").split(","):
        if p.count("*") == 2:
            types.append(ctypes.POINTER(ctypes.c_void_p))
        elif "int*" in p.replace(" ", ""):
            types.append(ctypes.POINTER(ctypes.c_int))
        elif "*" in p:
            types.append(ctypes.c_void_p)
        else:
            assert p.split()[0] == "int", p
            types.append(ctypes.c_int)
    return types


@pytest.mark.parametrize("name,argtypes", [
    ("composite", mk.COMPOSITE_ARGTYPES), ("delta", mk.DELTA_ARGTYPES),
    ("cascade", mk.CASCADE_ARGTYPES)])
def test_wrappers_declare_every_argument_of_the_c_entry_points(name,
                                                               argtypes):
    """Pointers as c_void_p, arrays as pointers, ints as c_int, in order:
    a pointer passed as a 32-bit int would be cut."""
    src = "megakernel" if name == "composite" else name
    assert argtypes == _signature(src, name)


def test_python_geometry_constants_match_the_kernels():
    """The constants both sides know: warps a block, a cluster's blocks
    at most, words a K step."""
    cuh = (CSRC / "conv_mma.cuh").read_text()
    mma = (CSRC / "member_mma.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(mma, "kWarps") == mk.CLUSTER_WARPS
    assert const(cuh, "kStepWords") == mk.STEP_WORDS
    assert const(mma, "kMaxCluster") == mk.MAX_CLUSTER
