"""Each CUDA kernel of the port vs its plain PyTorch version, on the card,
and one STE training step on the card vs the same step on the CPU.

Needs a CUDA device and the CUDA toolkit; skips without a device.  It
imports neither JAX nor ``repro``, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Every kernel of the chip tier is held bit-exact (tolerance 0), at
main-path shapes, and flash attention to repro's float tolerances; the
training step is held to ``optimizers.step_tolerance``;
``chip_smoke.py`` runs the full set.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.chip import interpreter, isa, networks
from repro_torch.kernels import binary_conv2x2_block as bcb
from repro_torch.kernels import cache as warmcache
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import xnor_matmul as xm
from repro_torch.launch import chip_serve
from repro_torch.serving import (ChipServer, FaultInjector, ServeFleet,
                                 VirtualClock, poisson_trace, replay)


def _words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _registry_convs():
    """Every distinct conv layer shape (h, w, c, f, pool) of the REGISTRY
    programs, with one program that has it."""
    shapes = {}
    for name in sorted(networks.REGISTRY):
        for _, h, w, c, f, pool in (st for st in interpreter.compile_plan(
                networks.REGISTRY[name]()).mega if st[0] == "conv"):
            shapes.setdefault((h, w, c, f, pool), name)
    return [(name,) + shape for shape, name in shapes.items()]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    odd = ((8, 32, 32, 256, False), (5, 29, 29, 256, True),
           (3, 14, 14, 64, True), (2, 9, 7, 128, False),
           (3, 10, 9, 32, True), (2, 7, 8, 32, False),     # one word, Cw 1
           (2, 5, 2500, 256, True), (1, 3, 4000, 256, False))  # chunks
    for b, h, w, c, pool in odd + tuple(
            (b, h, w, c, pool) for _, h, w, c, _, pool in _registry_convs()
            for b in (8, 3)):
        a, wt = _words(rng, b, h, w, c // 32), _words(rng, c, 4, c // 32)
        tau = torch.from_numpy(rng.integers(-4 * c, 4 * c + 1, c,
                                            dtype=np.int32))
        tau[:2] = torch.tensor([-2 ** 31, 2 ** 31 - 256])
        flip = torch.from_numpy(rng.integers(0, 2, c, dtype=np.int32))
        want = bcb.conv_block_body(a.to(dev), wt.to(dev), tau.to(dev),
                                   flip.to(dev), k4=4 * c, h=h, wd=w,
                                   pool=pool).cpu()
        got = bcb.binary_conv2x2_block(a.to(dev), wt.to(dev), tau.to(dev),
                                       flip.to(dev), c=c, pool=pool)
        assert torch.equal(got.cpu(), want), (b, h, w, c, pool)
    for m, n, k, pack in ((8, 10, 1024, False), (8, 64, 256, True),
                          (3, 256, 1600, True)):
        a, w = _words(rng, m, k // 32), _words(rng, n, k // 32)
        want = xm.xnor_matmul_plain(a, w, k, pack_out=pack)
        got = xm.xnor_matmul(a.to(dev), w.to(dev), k, pack_out=pack)
        assert torch.equal(got.cpu(), want), (m, n, k, pack)
    gen = torch.Generator().manual_seed(8)
    for name in sorted(networks.REGISTRY):
        prog = networks.REGISTRY[name]()
        params = interpreter.init_params(gen, prog, device="cpu")
        for p in params["conv"]:
            f = p["gamma"].shape[0]
            p["gamma"] = torch.randn(f, generator=gen)
            p["mean"] = torch.randn(f, generator=gen) * 16
        image = interpreter.fold_params(params, prog, image=True)
        io = prog.instrs[0]
        frames = torch.from_numpy(rng.integers(
            0, 2 ** io.bits, (5, io.height, io.width, io.in_channels),
            dtype=np.int32))
        spec = interpreter.compile_plan(prog).mega
        want = mk.megakernel_plain(image, frames, spec=spec)
        got = mk.megakernel_forward({k: v.to(dev) for k, v in image.items()},
                                    frames.to(dev), spec=spec)
        assert torch.equal(got.cpu(), want), name


def _random_image(prog, gen):
    params = interpreter.init_params(gen, prog, device="cpu")
    for p in params["conv"]:
        f = p["gamma"].shape[0]
        p["gamma"] = torch.randn(f, generator=gen)
        p["mean"] = torch.randn(f, generator=gen) * 16
    return interpreter.fold_params(params, prog, image=True)


def _frames(rng, prog, b):
    io = prog.instrs[0]
    return torch.from_numpy(rng.integers(
        0, 2 ** io.bits, (b, io.height, io.width, io.in_channels),
        dtype=np.int32))


@pytest.mark.gpu
def test_megakernel_at_the_serve_batch_matches_plain_version_on_the_card():
    """cifar9_s1 at the megakernel serve's other batch, 256 (more clusters
    than the card holds at once), and a ragged 131: the cluster body equals
    megakernel_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    prog = networks.REGISTRY["cifar9_s1"]()
    image = _random_image(prog, torch.Generator().manual_seed(14))
    spec = interpreter.compile_plan(prog).mega
    cimage = {k: v.to(dev) for k, v in image.items()}
    for b in (256, 131):
        frames = _frames(rng, prog, b).to(dev)
        want = mk.megakernel_plain(cimage, frames, spec=spec)
        got = mk.megakernel_forward(cimage, frames, spec=spec)
        assert torch.equal(got, want), b


@pytest.mark.gpu
def test_composite_and_cascade_match_plain_versions_on_the_card():
    """Every exact REGISTRY tiling with ragged member batches, and the
    face -> owner cascade over margins, a masked padding lane and drain
    schedules: whole outputs equal the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(10)
    progs = {n: networks.REGISTRY[n]() for n in networks.REGISTRY}
    images = {n: _random_image(p, gen) for n, p in progs.items()}
    for names in (("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector"),
                  ("cifar9_s2", "face_angles"),
                  ("cifar9_s2", "mnist5", "face_detector")):
        cplan, cimage = interpreter.pack_programs(
            {n: progs[n] for n in names}, {n: images[n] for n in names})
        frames = [_frames(rng, progs[n], b)
                  for n, b in zip(names, (6, 3, 1, 4))]
        want = mk.composite_plain(cimage, frames, spec=cplan.spec)
        got = mk.composite_forward(
            {k: v.to(dev) for k, v in cimage.items()},
            [f.to(dev) for f in frames], spec=cplan.spec)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), names
    cplan, cimage = interpreter.pack_cascade(
        {n: progs[n] for n in ("face_detector", "owner_detector")}, images,
        detector="face_detector", recognizer="owner_detector")
    dimage = {k: v.to(dev) for k, v in cimage.items()}
    frames = _frames(rng, progs["face_detector"], 7)
    for margin in (float("-inf"), 0.0, 5.5, float("inf")):
        ctrl = cplan.margin_ctrl(margin, 6)
        for bb, rb, ce in ((8, 8, 1), (3, 2, 2), (4, 1, 3)):
            kw = dict(spec=cplan.spec, bb=bb, rb=rb, check_every=ce)
            want = mk.cascade_plain(cimage, frames, ctrl, **kw)
            # the detector at the wrapper's pick (the recognizer's
            # clusters of 8 at this batch) and at its own clusters of 2
            for det_cluster in (0, 2):
                got = mk.cascade_forward(dimage, frames.to(dev),
                                         ctrl.to(dev), **kw,
                                         det_cluster=det_cluster)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), (margin, bb, rb, ce,
                                                     det_cluster)


@pytest.mark.gpu
def test_serving_on_a_side_stream_matches_the_default_stream():
    """With prefetch 2 the fetch thread copies results on its own stream;
    a server driven under a non-default stream must still hand back the
    labels the default stream gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prog = networks.REGISTRY["cifar9_s1"]()
    art = chip_serve.build_artifact(prog, seed=3, warm_bn=False,
                                    device="cuda")
    frames = chip_serve.frame_stream(prog, 48, 4)

    def serve():
        server = ChipServer({"cifar9_s1": prog}, {"cifar9_s1": art},
                            batch=8, megakernel=True, prefetch=2,
                            device="cuda")
        server.submit_many("cifar9_s1", frames)
        labels = [r.label for r in server.drain()]
        server.close()
        return labels

    want = serve()
    with torch.cuda.stream(torch.cuda.Stream()):
        got = serve()
    assert got == want


@pytest.mark.gpu
def test_delta_gate_matches_plain_version_on_the_card():
    """The delta-gated megakernel on cifar9_s1 and every other variant of
    the cifar10 family (B=8) and on mnist5 (B=5, n_real 3) over
    thresholds and drain schedules (the temporal serve's bb 8, rb 2
    among them), from a warm state whose deltas spread, and over three
    steps that carry the state on the card: logits, new_last, queue,
    counts and deltas equal ``delta_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.binarize import thermometer_pack
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(12)
    for name, b, n_real in (("cifar9_s1", 8, 8), ("cifar9_s2", 8, 8),
                            ("cifar9_s4", 8, 8), ("cifar9_s4t", 8, 8),
                            ("mnist5", 5, 3)):
        prog = networks.REGISTRY[name]()
        plan, image = interpreter.pack_delta(prog, _random_image(prog, gen))
        image = {k: v.to(dev) for k, v in image.items()}
        io = prog.instrs[0]
        levels = 2 ** io.bits
        frames = _frames(rng, prog, b).to(dev)
        prev = frames.clone()
        for i in range(1, b):          # lane i: an i x i patch changed
            prev[i, :i, :i] = (prev[i, :i, :i] + levels // 2) % levels
        last = thermometer_pack(prev, io.bits, io.in_channels, io.channels)
        llog = torch.from_numpy(rng.integers(-50, 50, (b, plan.classes),
                                             dtype=np.int32)).to(dev)
        # the plain version runs on the same CUDA tensors
        for thr in (float("-inf"), 0.0, 1.0, 2.5, 64.0, float("inf")):
            ctrl = plan.delta_ctrl(thr, n_real).to(dev)
            for bb, rb, ce in ((8, 8, 1), (8, 2, 1), (3, 2, 2), (4, 1, 3)):
                kw = dict(spec=plan.spec, bb=bb, rb=rb, check_every=ce)
                want = mk.delta_plain(image, frames, last, llog, ctrl, **kw)
                got = mk.delta_forward(image, frames, last, llog, ctrl, **kw)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (name, thr, bb, rb, ce)
        kstate = pstate = plan.init_state(b, device=dev)
        for step, thr in enumerate((float("-inf"), 1.0, 1.0)):
            ctrl = plan.delta_ctrl(thr, n_real).to(dev)
            got = mk.delta_forward(image, frames, *kstate, ctrl,
                                   spec=plan.spec, rb=2)
            want = mk.delta_plain(image, frames, *pstate, ctrl,
                                  spec=plan.spec, rb=2)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, step)
            kstate, pstate = (got[1], got[0]), (want[1], want[0])
            frames = frames.clone()
            frames[step::2] = (frames[step::2] + 1) % levels


@pytest.mark.gpu
def test_binary_conv2x2_and_binarize_pack_match_plain_versions_on_the_card():
    """The unfused packed conv at every REGISTRY conv shape at B=8 and B=3
    and at odd ones (c off the word grid up to 70 and 2048, ragged F, 3-D
    input, full-range words, a 2x2 map, maps too wide for one staged row,
    views not 16-byte aligned) and
    sign+pack with -0.0, NaN, +/-1e-30 and K off the word grid: equal to
    the plain versions, as int32 sums and as words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import binarize_pack as bp
    from repro_torch.kernels import binary_conv2x2 as bc
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    odd = (((8, 32, 32, 8), 256, 256), ((32, 31, 31, 2), 64, 64),
           ((3, 8, 9, 2), 40, 16), ((31, 31, 3), 70, 33),
           ((2, 2, 2, 1), 1, 1), ((5, 12, 7, 64), 2048, 40),
           ((1, 3, 500, 64), 2048, 40), ((2, 3, 4000, 8), 256, 33))
    for shape, c, f in odd + tuple(
            (((b, h, w, c // 32)), c, f)
            for _, h, w, c, f, _ in _registry_convs() for b in (8, 3)):
        a, w = _words(rng, *shape), _words(rng, f, 4, shape[-1])
        want = bc.binary_conv2x2_plain(a.to(dev), w.to(dev), c).cpu()
        got = bc.binary_conv2x2(a.to(dev), w.to(dev), c=c)
        assert torch.equal(got.cpu(), want), (shape, c, f)
    # maps and taps that start 4 bytes past a 16-byte boundary (views)
    a, w = _words(rng, 3 * 8 * 9 * 2 + 1), _words(rng, 16 * 4 * 2 + 1)
    a, w = a.to(dev)[1:].view(3, 8, 9, 2), w.to(dev)[1:].view(16, 4, 2)
    assert a.data_ptr() % 16 and w.data_ptr() % 16
    assert torch.equal(bc.binary_conv2x2(a, w, c=40),
                       bc.binary_conv2x2_plain(a, w, 40))
    for m, k in ((256, 960), (300, 100), (8 * 31 * 31, 256), (1, 1),
                 (5, 4096), (3, 32), (7, 96)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        x.view(-1)[:5] = torch.tensor([0.0, -0.0, float("nan"), 1e-30,
                                       -1e-30])[:min(5, m * k)]
        want = bp.binarize_pack_plain(x)
        # x as it is (the flat path where K % 32 == 0), and the same values
        # 4 bytes past a 16-byte boundary (the row path)
        xd = x.to(dev)
        off = torch.cat([xd.new_zeros(1), xd.flatten()])[1:].view(m, k)
        assert not bp.pack_path(k, off.data_ptr())
        assert bp.pack_path(k, xd.data_ptr()) == (k % 32 == 0)
        for xi in (xd, off):
            assert torch.equal(bp.binarize_pack(xi).cpu(), want), (m, k)


@pytest.mark.gpu
def test_xnor_matmul_on_the_tensor_cores_matches_plain_version_on_the_card():
    """The int32 xnor_matmul at BitLinear's SmolLM-360M shape (M=256,
    K=960, N=2560) and at ragged M, N and K (half an m16, one row past it,
    an N inside one n8 tile, odd N, one bit, K off the 256-bit grid, 16
    staged chunks), on random words with bits set past K, with aligned
    operands and with operands 4 bytes past a 16-byte boundary: equal to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    shapes = [(256, 2560, 960)] + [(m, n, k) for m in (1, 15, 17, 300)
                                    for n in (1, 10, 33)
                                    for k in (1, 31, 100, 1600, 4096)]
    for m, n, k in shapes:
        kw = -(-k // 32)
        a, w = _words(rng, m, kw).to(dev), _words(rng, n, kw).to(dev)
        want = xm.xnor_matmul_plain(a, w, k)
        assert torch.equal(xm.xnor_matmul(a, w, k), want), (m, n, k)
        # K staged one step a chunk: double-buffered wherever K has more
        t = xm.make_tiles(m, n, kw, xm.xnor_tiles(m, n, kw).wm, 1, 1)
        assert torch.equal(xm.xnor_matmul(a, w, k, tiles=t), want), \
            (m, n, k, t)
    for m, n, k in ((256, 2560, 960), (17, 33, 100)):
        kw = -(-k // 32)
        a = _words(rng, m * kw + 1).to(dev)[1:].view(m, kw)
        w = _words(rng, n * kw + 1).to(dev)[1:].view(n, kw)
        assert xm.copy_words(kw, a.data_ptr(), w.data_ptr()) == 1
        assert torch.equal(xm.xnor_matmul(a, w, k),
                           xm.xnor_matmul_plain(a, w, k)), (m, n, k)


@pytest.mark.gpu
def test_packed_xnor_matmul_on_the_tensor_cores_matches_plain_version():
    """The packed xnor_matmul (the same GEMM, sign-and-pack epilogue) at
    mnist5's hidden layer (M=8, K=256, N=64), at the serve batch (M=256)
    and at M=256, K=960, N=2560, then at ragged M and K (one row, one
    past an m16, K off the word and the 256-bit step) with one word or
    several, with aligned operands and 4 bytes off: equal, bit for bit, to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    shapes = [(8, 64, 256), (256, 64, 256), (256, 2560, 960)] + [
        (m, n, k) for m in (1, 17) for n in (32, 96, 2560)
        for k in (1, 100, 960, 4096)]
    for m, n, k in shapes:
        kw = -(-k // 32)
        a, w = _words(rng, m, kw).to(dev), _words(rng, n, kw).to(dev)
        t = xm.xnor_tiles(m, n, kw, pack=True)
        assert t.tn in xm.PACK_WARP_TILES
        assert torch.equal(xm.xnor_matmul(a, w, k, pack_out=True),
                           xm.xnor_matmul_plain(a, w, k, pack_out=True)), \
            (m, n, k)
    for m, n, k in ((256, 2560, 960), (17, 64, 100)):
        kw = -(-k // 32)
        a = _words(rng, m * kw + 1).to(dev)[1:].view(m, kw)
        w = _words(rng, n * kw + 1).to(dev)[1:].view(n, kw)
        assert torch.equal(xm.xnor_matmul(a, w, k, pack_out=True),
                           xm.xnor_matmul_plain(a, w, k, pack_out=True)), \
            (m, n, k)


@pytest.mark.gpu
def test_training_step_on_the_card_equals_the_cpu():
    """One face-detector STE step (forward, backward, adamw) from the same
    params and state on the card and on the CPU: latents within
    ``step_tolerance``, BN statistics rtol 1e-5, logits exact; then the
    card's eval forward: float conv == packed conv (binary_conv2x2) at
    every conv layer, and BitLinear's packed path == its STE forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import binary_layers
    from repro_torch.core.chip import neuron_array as na
    from repro_torch.device import to_device
    from repro_torch.examples import always_on_detector as det
    from repro_torch.examples.quickstart import train_step
    from repro_torch.optim import optimizers as opt
    assert not torch.backends.cuda.matmul.allow_tf32
    prog = networks.face_detector()
    params = interpreter.init_params(torch.Generator().manual_seed(5), prog,
                                     device="cpu")
    sched = opt.cosine_schedule(2e-3, 20, 40)
    optimizer = opt.make("adamw", sched)
    images, labels = det.detector_batch(3, 16, device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        p = to_device(params, torch.device(where))
        out[where] = train_step(p, optimizer.init(p), 3, images.to(where),
                                labels.to(where), prog=prog,
                                optimizer=optimizer, loss_fn=det.detector_loss)
    _, grads = opt.value_and_grad(
        lambda q: (det.detector_loss(interpreter.forward_train(
            q, prog, images)[0], labels), None), params)
    bounds = opt.step_tolerance(out["cpu"][0], grads, float(sched(3)))
    for part in ("conv", "fc"):
        for i, layer in enumerate(out["cpu"][0][part]):
            for k, want in layer.items():
                got = out["cuda"][0][part][i][k].cpu()
                if k in ("mean", "var"):
                    assert torch.allclose(got, want, rtol=1e-5, atol=0)
                else:
                    assert bool((got - want).abs().le(
                        bounds[part][i][k]).all()), (part, i, k)
    trained = out["cuda"][0]
    folded = interpreter.fold_params(trained, prog)
    x = na.thermometer_encode(images[:4].cuda(), prog.instrs[0].bits,
                              prog.instrs[0].channels)
    convs = [ins for ins in prog.instrs if isinstance(ins, isa.ConvInstr)]
    for ins, layer in zip(convs, folded["conv"]):
        s = na.conv2x2(x, layer["w"])
        assert torch.equal(na.conv2x2_packed(x, layer["w"]), s)
        x = na.comparator(s, layer["tau"], layer["flip"])
        if ins.maxpool:
            x = na.maxpool2x2(x)
    bl = binary_layers.init(torch.Generator().manual_seed(6), 960, 256,
                            device="cuda")
    xs = torch.randn((64, 960), generator=torch.Generator().manual_seed(7))
    assert torch.equal(binary_layers.apply_infer(bl, xs.cuda()),
                       binary_layers.apply_train(bl, xs.cuda()))


@pytest.mark.gpu
def test_flash_attention_matches_plain_version_on_the_card():
    """The flash-attention kernel vs its plain version at small shapes
    (G = 3 with a ragged S, whose 16-row fragments straddle positions; G = 4
    with D = 128; MQA with D = 128, not causal; the scaled() configs' head
    dims 32 and 16, the latter not causal; head dims 8 (G = 8 and MHA, not
    causal) and 20 (MHA, and G = 3 not causal) on the next instantiation
    up; D = 64 and 20 from inputs 2 bytes off a 16-byte boundary), in both
    types and every probability type: within 2e-5 where the chain is
    float32 throughout, 3e-2 where p or the output is bf16 (repro's
    tolerances), and at a given probability type ten times closer on the
    mean to the plain version at that type than at the other; a head dim
    of 129 raises, a block of no heads comes back empty with no launch.
    Prefills of a small SmolLM-shaped model through the kernel, float32
    and bf16, launch it once per layer and match the chunked forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    gen = torch.Generator().manual_seed(11)
    for b, s, h, kh, d, causal, off in ((2, 77, 6, 2, 64, True, 0),
                                        (1, 96, 16, 4, 128, True, 0),
                                        (1, 130, 8, 1, 128, False, 0),
                                        (2, 70, 6, 2, 32, True, 0),
                                        (1, 90, 4, 4, 16, False, 0),
                                        (2, 100, 8, 1, 8, True, 0),
                                        (1, 90, 4, 4, 8, False, 0),
                                        (2, 77, 3, 3, 20, True, 0),
                                        (2, 64, 6, 2, 20, False, 0),
                                        (2, 77, 6, 2, 64, True, 1),
                                        (1, 70, 3, 3, 20, True, 1)):
        qkv = [torch.randn(shape, generator=gen) for shape in
               ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
        for dtype in (torch.float32, torch.bfloat16):
            # off: each input one element past its storage's start
            q, k, v = (torch.cat([x.new_zeros(off), x.flatten()]).to(
                dtype).cuda()[off:].view(x.shape) for x in qkv)
            for probs_bf16 in (None, True, False):
                f32_chain = (dtype == torch.float32
                             and not fa.bf16_probs_of(dtype, probs_bf16))
                tol = 2e-5 if f32_chain else 3e-2
                got = fa.flash_attention(q, k, v, causal=causal,
                                         probs_bf16=probs_bf16)
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                probs_bf16=probs_bf16)
                torch.cuda.synchronize()
                assert got.dtype == dtype
                assert torch.allclose(got.float(), want.float(), rtol=tol,
                                      atol=tol), (b, s, h, kh, d, dtype,
                                                  probs_bf16)
                if probs_bf16 is not None:
                    # the types differ by a few ulps at most, inside the
                    # tolerance; the mean error tells them apart (a sound
                    # kernel sits hundreds of times closer to its own)
                    other = fa.flash_attention_plain(
                        q, k, v, causal=causal, probs_bf16=not probs_bf16)
                    e_same, e_other = ((got.float() - x.float()).abs().mean()
                                       for x in (want, other))
                    assert e_same * 10 < e_other, (b, s, h, kh, d, dtype,
                                                   probs_bf16, float(e_same),
                                                   float(e_other))
    # a head dim past the largest instantiation is refused, not rerouted
    q = torch.zeros((1, 8, 2, 129), device="cuda")
    with pytest.raises(ValueError, match="1 to 128"):
        fa.flash_attention(q, q, q)
    # a block of no heads (a sharded step's last device where the heads do
    # not fill the devices) comes back empty, nothing launched
    ops.reset_launch_counts()
    q = torch.zeros((2, 8, 0, 64), device="cuda", dtype=torch.bfloat16)
    out = fa.flash_attention(q, q, q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert ops.launch_counts()["flash_attention"] == 0
    cfg = get_config("smollm-360m").with_(num_layers=3, d_model=192,
                                          num_heads=6, num_kv_heads=2,
                                          d_ff=256, vocab_size=1000,
                                          dtype="float32")
    params = transformer.init_params(cfg, seed=1, device="cuda")
    toks = torch.randint(0, 1000, (2, 40), generator=gen).to(torch.int32)
    for c, tol in ((cfg, 1e-4), (cfg.with_(dtype="bfloat16"), 3e-2)):
        ops.reset_launch_counts()
        h, _, _ = transformer.forward(params, c, {"tokens": toks.cuda()},
                                      mode="prefill")
        assert ops.launch_counts()["flash_attention"] == 3
        ref, _, _ = transformer.forward(params, c, {"tokens": toks.cuda()},
                                        mode="train")
        assert torch.isfinite(h).all()
        assert torch.allclose(h.float(), ref.float(), rtol=tol, atol=tol)


def _replay_labels(server, trace, frames, clock):
    """A VirtualClock replay through ``server``: (rid, label, dispatch,
    t_submit, t_done) of every result, the pad targets launched, the
    ledger."""
    results = replay(server, trace, {trace.lane[0]: frames}, clock=clock,
                     sleep=clock.sleep)
    server.close()
    st = server.stats()
    assert st.billed == st.total_served + sum(st.padded.values())
    return ([(r.rid, r.label, r.dispatch, r.t_submit, r.t_done)
             for r in results], st.dispatch_sizes, st.billed)


@pytest.mark.gpu
def test_continuous_serving_at_every_ladder_size_matches_plain_versions():
    """The continuous policy's ladder at batch 32 on cifar9_s1: the
    megakernel and the staged lane (conv_block, xnor_matmul) at each size
    1, 2, 4, ..., 32 equal their plain versions, and a Poisson replay under
    a VirtualClock serves the same results on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    prog = networks.REGISTRY["cifar9_s1"]()
    plan = interpreter.compile_plan(prog)
    art = chip_serve.build_artifact(prog, seed=5, warm_bn=True, device="cpu")
    image = interpreter.ensure_image(art, prog)
    cimage = {k: v.to(dev) for k, v in image.items()}
    for b in (1, 2, 4, 8, 16, 32):
        frames = _frames(rng, prog, b)
        want = mk.megakernel_plain(image, frames, spec=plan.mega)
        got = mk.megakernel_forward(cimage, frames.to(dev), spec=plan.mega)
        assert torch.equal(got.cpu(), want), b
        s_l, s_y = plan.forward(art, frames, device="cpu")
        g_l, g_y = plan.forward(art, frames, device=dev)
        assert torch.equal(g_l.cpu(), s_l) and torch.equal(g_y.cpu(), s_y), b
    trace = poisson_trace(["cifar9_s1"], 400.0, 48, seed=2)
    frames = chip_serve.frame_stream(prog, 16, 6)
    runs = []
    for where, megakernel in ((dev, True), (dev, False), ("cpu", True)):
        vc = VirtualClock()
        server = ChipServer({"cifar9_s1": prog}, {"cifar9_s1": art},
                            batch=32, megakernel=megakernel, device=where,
                            policy="continuous", slo_ms=50.0, clock=vc)
        runs.append(_replay_labels(server, trace, frames, vc))
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[0][1]) > 1             # several ladder sizes ran


@pytest.mark.gpu
def test_two_replica_failover_on_the_card_matches_the_cpu():
    """Two replicas sharing the card, mnist5 and cifar9_s1 on staged
    lanes, host0 killed after 8 served frames and replaced: no frame
    lost, every label equal to the CPU fleet's under the same kill
    schedule, the bill exact, the replacement warm-started.  A replica
    over the group (cuda:0, cuda:0) serves the same labels as one over
    cuda:0 alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    progs = {n: networks.REGISTRY[n]() for n in ("mnist5", "cifar9_s1")}
    arts = {n: chip_serve.build_artifact(p, seed=i, warm_bn=True,
                                         device="cpu")
            for i, (n, p) in enumerate(progs.items())}
    streams = {n: chip_serve.frame_stream(p, 20, 30 + i)
               for i, (n, p) in enumerate(progs.items())}
    runs = []
    for devices in (None, ["cpu"]):
        warmcache.invalidate()
        vc = VirtualClock()
        fleet = ServeFleet(progs, arts, replicas=2, batch=4, devices=devices,
                           injector=FaultInjector("host0", 8), replace=True,
                           prefetch=2, clock=vc, sleep=vc.sleep)
        results = []
        for j in range(20):
            for n in progs:
                fleet.submit(n, streams[n][j])
            if j % 4 == 3:
                results.extend(fleet.step())
        results = sorted(results + fleet.drain(), key=lambda r: r.rid)
        fleet.close()
        st = fleet.stats()
        assert [r.rid for r in results] == list(range(40))
        assert st.billed == st.total_served + sum(st.padded.values())
        assert st.failed_replicas == ("host0",)
        assert st.warm_start["hits"] >= 2
        runs.append(([(r.rid, r.program, r.label) for r in results],
                     st.migrated_frames, st.refired_frames,
                     {n: s.total_served for n, s in st.replicas.items()}))
    assert runs[0] == runs[1]
    labels = []
    for mesh in (("cuda:0",), ("cuda:0", "cuda:0")):
        server = ChipServer(progs, arts, batch=4, mesh=mesh)
        for n in progs:
            server.submit_many(n, streams[n][:10])
        labels.append(sorted((r.rid, r.label) for r in server.drain()))
    assert labels[0] == labels[1]


@pytest.mark.gpu
def test_autotune_candidates_are_bit_exact_and_steer_the_card(tmp_path,
                                                              monkeypatch):
    """Every candidate of the three tuners' grids at B=8 (the cluster
    sizes at cifar9_s1 and the 4 x S=4 quad, the staged conv geometries
    at cifar9_s1) equals the plain version on the card; each tuner
    records a winner, and the plans' next launch takes it (read from the
    geometry the wrapper computes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    autotune.invalidate()
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    gen = torch.Generator().manual_seed(32)
    clusters = []
    real_geo = mk.cluster_geometry
    monkeypatch.setattr(mk, "cluster_geometry", lambda spec, c=0: (
        clusters.append(real_geo(spec, c).cluster) or real_geo(spec, c)))
    prog = networks.REGISTRY["cifar9_s1"]()
    plan = interpreter.compile_plan(prog)
    image = {k: v.to(dev) for k, v in _random_image(prog, gen).items()}
    frames = _frames(rng, prog, 8).to(dev)
    want = mk.megakernel_plain(image, frames, spec=plan.mega).float()
    for c in autotune.CLUSTERS:
        assert torch.equal(plan.forward_mega(image, frames, device=dev,
                                             cluster=c)[0], want), c
    entry = autotune.tune_mega(plan, image, frames, iters=1)
    formula = real_geo(mk.solo_member_spec(plan.mega)).cluster
    clusters.clear()
    plan.forward_mega(image, frames, device=dev)
    assert clusters == [entry["cluster"] or formula]      # 0: the formula
    packed = interpreter.fold_params(interpreter.init_params(
        gen, prog, device="cpu"), prog, packed=True)
    ref = plan.forward(packed, frames, device=dev)[0]
    for ns in autotune.NSLICES:
        for rows in autotune.ROWS:
            got = plan.forward(packed, frames, device=dev,
                               conv_tiles=(ns, rows))[0]
            assert torch.equal(got, ref), (ns, rows)
    entry = autotune.tune_staged_conv(plan, packed, frames, iters=1)
    assert autotune.conv_tiles(prog, 8, device=dev) == (
        entry["nslices"], entry["rows"])
    progs = {n: networks.REGISTRY[n]() for n in
             ("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector")}
    images = {n: _random_image(p, gen) for n, p in progs.items()}
    cplan, cimage = interpreter.pack_programs(progs, images)
    cimage = {k: v.to(dev) for k, v in cimage.items()}
    qframes = tuple(_frames(rng, p, 8).to(dev) for p in progs.values())
    qwant = mk.composite_plain(cimage, qframes, spec=cplan.spec)
    for c in autotune.CLUSTERS:
        got = cplan.forward(cimage, qframes, device=dev, cluster=c)[0]
        assert all(torch.equal(g, w.float()) for g, w in zip(got, qwant)), c
    entry = autotune.tune_composite(cplan, cimage, qframes, iters=1)
    clusters.clear()
    cplan.forward(cimage, qframes, device=dev)
    assert clusters == [entry["cluster"] or real_geo(cplan.spec).cluster]
    autotune.invalidate()


@pytest.mark.gpu
def test_delta_recompute_at_every_cluster_candidate_matches_plain(
        tmp_path, monkeypatch):
    """DeltaPlan.forward_delta at every size of tune_mega's grid (the
    megakernel's cache entry steers it), cifar9_s1 B=8 from a warm state
    with 8, 5 (lane 0 unchanged: the drain's lane-0 rule) and 0 lanes
    changed, at two drain schedules: logits, new_last, queue, counts and
    deltas equal delta_plain on the card; a recorded megakernel entry is
    the cluster forward_delta launches next."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.binarize import thermometer_pack
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    autotune.invalidate()
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    gen = torch.Generator().manual_seed(42)
    prog = networks.REGISTRY["cifar9_s1"]()
    plan, image = interpreter.pack_delta(prog, _random_image(prog, gen))
    image = {k: v.to(dev) for k, v in image.items()}
    io = prog.instrs[0]
    levels = 2 ** io.bits
    frames = _frames(rng, prog, 8).to(dev)
    llog = torch.from_numpy(rng.integers(-50, 50, (8, plan.classes),
                                         dtype=np.int32)).to(dev)
    ctrl = plan.delta_ctrl(1.0, 8).to(dev)
    for lanes in (tuple(range(8)), (1, 2, 4, 6, 7), ()):
        prev = frames.clone()
        for i in lanes:
            prev[i, :2, :2] = (prev[i, :2, :2] + levels // 2) % levels
        last = thermometer_pack(prev, io.bits, io.in_channels, io.channels)
        for rb in (0, 2):
            want = mk.delta_plain(image, frames, last, llog, ctrl,
                                  spec=plan.spec, rb=rb)
            assert int(want[3][0]) == len(lanes)
            for c in autotune.CLUSTERS:
                got = plan.forward_delta(image, frames, last, llog, ctrl,
                                         device=dev, rb=rb, cluster=c)
                for g, w in zip(got[2:], (want[1], want[0]) + want[2:]):
                    assert torch.equal(g, w), (lanes, rb, c)
    clusters = []
    real_geo = mk.cluster_geometry
    monkeypatch.setattr(mk, "cluster_geometry", lambda spec, c=0: (
        clusters.append(real_geo(spec, c).cluster) or real_geo(spec, c)))
    for c in (1, 4):
        autotune.record("mega", autotune.program_key(prog), 8,
                        {"cluster": c}, device=dev)
        clusters.clear()
        plan.forward_delta(image, frames, last, llog, ctrl, device=dev)
        assert clusters == [c]
    autotune.invalidate()


@pytest.mark.gpu
def test_adafactor_lm_step_on_the_card_equals_the_cpu():
    """One adafactor train step of SmolLM's scaled() config in float32
    from the same state and batch on the card and on the CPU: the loss
    within 2e-4 and the parameters within ``step_tolerance``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.device import to_device
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import steps
    cfg = get_config("smollm-360m").scaled().with_(
        dtype="float32", param_dtype="float32", optimizer="adafactor")
    sched = opt.cosine_schedule(1e-3, 2, 10)
    optimizer = opt.make("adafactor", sched)
    state = steps.create_state(cfg, 4, optimizer, device="cpu")
    batch = dtok.batch_for_step(cfg, 0, global_batch=4, seq_len=64,
                                device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        out[where] = steps.build_train_step(cfg, optimizer)(
            to_device(state, torch.device(where)),
            {k: v.to(where) for k, v in batch.items()})
    assert abs(float(out["cuda"][1]["loss"])
               - float(out["cpu"][1]["loss"])) <= 2e-4
    _, grads = opt.value_and_grad(
        lambda p: steps.make_loss_fn(cfg)(p, batch), state["params"])
    want = out["cpu"][0]["params"]
    bounds = opt.step_tolerance(want, grads, float(sched(0)))
    for w, g, b in zip(opt.tree_leaves(want),
                       opt.tree_leaves(out["cuda"][0]["params"]),
                       opt.tree_leaves(bounds)):
        assert bool((g.cpu() - w).abs().le(b).all())


def _comparable(first, b, positions):
    """(B, P) mask of the positions before each row's first token the two
    runs routed differently (``moe.route_divergence``)."""
    return torch.tensor([[p < first.get(r, float("inf")) for p in positions]
                         for r in range(b)])


@pytest.mark.gpu
def test_olmoe_prefill_through_flash_matches_plain_on_the_card(monkeypatch):
    """OLMoE-1B-7B at full width and two layers, float32: the prefill
    logits through the flash kernel (a launch a layer, head dim 128) ==
    through its plain version within 2e-4, where both runs routed alike
    (every token routed differently must be a near-tie)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    cfg = get_config("olmoe-1b-7b").with_(dtype="float32", num_layers=2)
    params = transformer.init_params(cfg, seed=2, device="cuda")
    b, s = 2, 256
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).cuda()
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(
                ops, "flash_attention",
                lambda q, k, v, *, causal=True, scale=None, probs_bf16=None:
                fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                         probs_bf16=probs_bf16))
        ops.reset_launch_counts()
        with moe.record_routes() as rec:
            h, _, _ = transformer.forward(params, cfg, {"tokens": toks},
                                          mode="prefill")
            logits = transformer.lm_logits(params, cfg, h)
        assert ops.launch_counts()["flash_attention"] == (0 if plain else 2)
        out.append((logits.cpu(), moe.route_table(rec, [(0, s)], 2)))
    monkeypatch.undo()
    first, _ = moe.route_divergence(out[0][1], out[1][1])
    keep = _comparable(first, b, range(s))
    assert keep.any()
    assert torch.isfinite(out[0][0]).all()
    assert torch.allclose(out[0][0][keep], out[1][0][keep], rtol=2e-4,
                          atol=2e-4)


@pytest.mark.gpu
def test_jamba_scaled_prefill_and_decode_on_the_card_equal_the_cpu():
    """Jamba's scaled() config (Mamba, attention through the flash kernel
    at head dim 16, MoE) with two pattern repeats in float32: prefill and
    decode logits on the card == on the CPU within 2e-4 under the
    near-tie rule, the recurrent states written into the stacked cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.device import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve
    cfg = get_config("jamba-v0.1-52b").scaled().with_(dtype="float32",
                                                      param_dtype="float32")
    cfg = cfg.with_(num_layers=2 * len(cfg.pattern))
    params = transformer.init_params(cfg, seed=5, device="cpu")
    b, s, k = 2, 20, 4
    toks = torch.randint(0, cfg.vocab_size, (b, s + k),
                         generator=torch.Generator().manual_seed(9),
                         dtype=torch.int32)
    n = sum(kind.endswith("_moe") for kind in cfg.pattern) * 2
    out = []
    for where in ("cpu", "cuda"):
        p, t = to_device(params, torch.device(where)), toks.to(where)
        ops.reset_launch_counts()
        with moe.record_routes() as rec:
            logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(
                p, {"tokens": t[:, :s]})
            outs = [logits]
            for i in range(k):
                logits, cache = serve.build_decode_step(cfg)(
                    p, cache, t[:, s + i][:, None], s + i)
                outs.append(logits)
        assert ops.launch_counts()["flash_attention"] == (
            2 if where == "cuda" else 0)
        out.append((torch.cat(outs, dim=1).cpu(), moe.route_table(
            rec, [(0, s)] + [(s + i, 1) for i in range(k)], n)))
    first, _ = moe.route_divergence(out[1][1], out[0][1])
    keep = _comparable(first, b, range(s - 1, s + k))
    assert keep.any()
    assert torch.allclose(out[1][0][keep], out[0][0][keep], rtol=2e-4,
                          atol=2e-4)


def _two_layer_run(arch, where, params, b, s, k):
    """Prefill s positions and decode k steps of ``arch`` at full width
    and two layers on ``where``: MusicGen on 4-codebook tokens, Qwen2-VL
    on the VLM batch's embeds and M-RoPE grid (decode steps at (s+i,
    s+i, s+i)).  Returns (prefill + decode logits on the CPU, the flash
    launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.device import to_device
    from repro_torch.kernels import ops
    from repro_torch.train import serve
    cfg = get_config(arch).with_(dtype="float32", num_layers=2)
    p = to_device(params, torch.device(where))
    if cfg.embed_inputs:
        toks = torch.randint(0, cfg.vocab_size, (b, s + k, cfg.num_codebooks),
                             generator=torch.Generator().manual_seed(4),
                             dtype=torch.int32).to(where)
        prompt = {"tokens": toks[:, :s]}
    else:
        batch = dtok.vlm_batch_for_step(cfg, 0, global_batch=b,
                                        seq_len=s + k, device=where)
        toks = batch["embeds"]
        prompt = {"embeds": toks[:, :s],
                  "positions": batch["positions"][:, :s]}
    ops.reset_launch_counts()
    logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(p, prompt)
    outs = [logits]
    for i in range(k):
        logits, cache = serve.build_decode_step(cfg)(
            p, cache, toks[:, s + i][:, None], s + i)
        outs.append(logits)
    return (torch.cat(outs, dim=1).cpu(),
            ops.launch_counts()["flash_attention"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_codebook_and_vlm_prefill_and_decode_on_the_card(arch, monkeypatch):
    """MusicGen-medium and Qwen2-VL-2B at full width and two layers in
    float32: the prefill logits through the flash kernel (a launch a
    layer) == through its plain version, and prefill + decode on the card
    == on the CPU, within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.device import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cfg = get_config(arch).with_(dtype="float32", num_layers=2)
    params = transformer.init_params(cfg, seed=2, device="cpu")
    b, s, k = 2, 128, 3
    p = to_device(params, torch.device("cuda"))
    if cfg.embed_inputs:
        prompt = {"tokens": torch.randint(
            0, cfg.vocab_size, (b, s, cfg.num_codebooks),
            generator=torch.Generator().manual_seed(3),
            dtype=torch.int32).cuda()}
    else:
        batch = dtok.vlm_batch_for_step(cfg, 1, global_batch=b, seq_len=s,
                                        device="cuda")
        prompt = {"embeds": batch["embeds"], "positions": batch["positions"]}
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(
                ops, "flash_attention",
                lambda q, k, v, *, causal=True, scale=None, probs_bf16=None:
                fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                         probs_bf16=probs_bf16))
        ops.reset_launch_counts()
        h, _, _ = transformer.forward(p, cfg, prompt, mode="prefill")
        out.append(transformer.lm_logits(p, cfg, h).cpu())
        assert ops.launch_counts()["flash_attention"] == (0 if plain else 2)
    monkeypatch.undo()
    assert torch.isfinite(out[0]).all()
    assert torch.allclose(out[0], out[1], rtol=2e-4, atol=2e-4)
    del p
    card, flash = _two_layer_run(arch, "cuda", params, b, s, k)
    cpu, none = _two_layer_run(arch, "cpu", params, b, s, k)
    assert flash == 2 and none == 0
    assert torch.allclose(card, cpu, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_smollm_prefill_counts_on_the_card_equal_meta_and_flash_op():
    """``launch.op_cost`` counts SmolLM-360M's full-width prefill (B=4,
    S=512, bf16) on the card exactly as on meta tensors at the same shape
    (the counter reads shapes, strides and types only), the step
    launching the flash kernel once a layer inside the count; and the
    dispatcher op ``repro_torch::flash_attention`` on CUDA tensors equals
    its plain version (it launches the kernel: no fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models import transformer
    cfg = get_config("smollm-360m")
    fn, meta_args = dryrun.step_and_args(
        cfg, shp.ShapeSpec("prefill", 512, 4, "prefill"))
    meta = op_cost.count(fn, *meta_args)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    toks = dtok.batch_for_step(cfg, 0, global_batch=4, seq_len=512,
                               device="cuda")["tokens"]
    ops.reset_launch_counts()
    card = op_cost.count(fn, params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    assert (card.flops, card.bytes) == (meta.flops, meta.bytes)
    assert card.argument_bytes == meta.argument_bytes
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).cuda()
                   for shape in ((2, 100, 6, 64), (2, 100, 2, 64),
                                 (2, 100, 2, 64)))
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        for causal in (True, False):
            ops.reset_launch_counts()
            got = torch.ops.repro_torch.flash_attention(q, k, v, causal,
                                                        None, None)
            assert ops.launch_counts()["flash_attention"] == 1
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol), (dtype, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen1.5-110b",
                                  "musicgen-medium"])
def test_scaled_head_dims_prefill_and_decode_on_the_card_equal_the_cpu(arch):
    """The scaled() configs whose head dims the kernel pads (kimi-k2 and
    qwen1.5-110b: 8, G = 8; musicgen-medium: 20, four codebooks) in
    float32: prefill through the flash kernel (a launch an attention
    layer) and decode on the card == on the CPU within 2e-4, where both
    runs routed alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.device import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve
    cfg = get_config(arch).scaled().with_(dtype="float32",
                                          param_dtype="float32")
    kinds = cfg.prefix + cfg.pattern * cfg.num_pattern_repeats
    n_attn = sum(k in transformer.ATTN_KINDS for k in kinds)
    n_moe = sum(k.endswith("_moe") for k in kinds)
    params = transformer.init_params(cfg, seed=6, device="cpu")
    b, s, k = 2, 100, 4
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab_size, (b, s + k) + cb,
                         generator=torch.Generator().manual_seed(10),
                         dtype=torch.int32)
    out = []
    for where in ("cpu", "cuda"):
        p, t = to_device(params, torch.device(where)), toks.to(where)
        ops.reset_launch_counts()
        with moe.record_routes() as rec:
            logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(
                p, {"tokens": t[:, :s]})
            outs = [logits]
            for i in range(k):
                logits, cache = serve.build_decode_step(cfg)(
                    p, cache, t[:, s + i][:, None], s + i)
                outs.append(logits)
        assert ops.launch_counts()["flash_attention"] == (
            n_attn if where == "cuda" else 0)
        out.append((torch.cat(outs, dim=1).cpu(), moe.route_table(
            rec, [(0, s)] + [(s + i, 1) for i in range(k)], n_moe)))
    first, _ = moe.route_divergence(out[1][1], out[0][1])
    keep = _comparable(first, b, range(s - 1, s + k))
    assert keep.any() and torch.isfinite(out[1][0]).all()
    assert torch.allclose(out[1][0][keep], out[0][0][keep], rtol=2e-4,
                          atol=2e-4)


@pytest.mark.gpu
def test_one_rank_training_step_under_the_host_mesh_on_the_card():
    """The host mesh over the one card, on a one-rank process group: every
    leaf of SmolLM scaled()'s train state shards to its full shape, and
    one adamw step under ``mesh_context(make_host_mesh())`` equals the same
    step outside it, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import steps
    cfg = get_config("smollm-360m").scaled()
    optimizer = topt.make("adamw", topt.cosine_schedule(3e-4, warmup=100,
                                                        total=10000))
    batch = tokens.batch_for_step(cfg, 0, global_batch=4, seq_len=32,
                                  device="cuda")
    step = steps.build_train_step(cfg, optimizer)
    mesh = tmesh.make_host_mesh(devices=["cuda:0"])

    def run():
        return step(steps.create_state(cfg, 0, optimizer), batch)

    with dctx.local_process_group():
        named = dict(shd.leaves_with_path(shd.to_named(
            mesh, steps.state_specs(cfg, mesh, optimizer))))
        for path, leaf in shd.leaves_with_path(steps.state_shape(
                cfg, optimizer)):
            assert named[path].shard_shape(leaf.shape) == tuple(leaf.shape)
        with dctx.mesh_context(mesh):
            inside, _ = run()
    outside, _ = run()
    for (path, a), (_, b) in zip(shd.leaves_with_path(inside),
                                 shd.leaves_with_path(outside)):
        assert torch.equal(a, b), path


@pytest.mark.gpu
@pytest.mark.parametrize("arch,step,seq", [("rwkv6-3b", "prefill", 64),
                                           ("rwkv6-3b", "train", 32),
                                           ("jamba-v0.1-52b", "train", 32)])
def test_recurrent_counts_on_the_card_equal_scaled_meta(arch, step, seq):
    """The scaled() per-token recurrences counted on CUDA tensors (every
    iteration runs) == on meta (``op_cost.scan``: one middle iteration,
    its charges scaled), FLOPs and bytes exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import shapes
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models import transformer
    from repro_torch.train import steps
    cfg = get_config(arch).scaled()
    fn, meta_args = dryrun.step_and_args(
        cfg, shapes.ShapeSpec("small", seq, 2, step))
    meta = op_cost.count(fn, *meta_args)
    batch = tokens.batch_for_step(cfg, 0, global_batch=2, seq_len=seq,
                                  device="cuda")
    args = ((steps.create_state(cfg, 0, dryrun.build_optimizer(cfg)), batch)
            if step == "train" else
            (transformer.init_params(cfg), {"tokens": batch["tokens"]}))
    card = op_cost.count(fn, *args)
    assert (card.flops, card.bytes) == (meta.flops, meta.bytes)


@pytest.mark.gpu
def test_collectives_at_world_size_one_on_the_card():
    """Smoke phase 10 at OLMoE scaled()'s width on a one-rank group (NCCL
    for the card's tensors, gloo for the CPU's): apply_ep and
    apply_ep_decode at capacity factor E / k == apply_dense, and at the
    config's factor == the CPU's (every token routed alike at this size);
    the compressed psum == compress + decompress, bit for bit; a one-stage
    pipeline == the stage, with its gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.checkpoint.ckpt import make_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed.pipeline import pipelined
    from repro_torch.models import moe
    from repro_torch.optim import grad_compress as gc
    dev = torch.device("cuda", 0)
    tol = 2e-4
    cfg = get_config("olmoe-1b-7b").scaled().with_(dtype="float32",
                                                  param_dtype="float32")
    m = cfg.moe
    params = moe.init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    with dctx.local_process_group("cpu:gloo,cuda:nccl"):
        mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
        cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
        card = {k: v.to(dev) for k, v in params.items()}
        for path, s in ((moe.apply_ep, 16), (moe.apply_ep_decode, 1)):
            x = torch.randn((2, s, cfg.d_model), generator=gen)
            free = cfg.with_(moe=dataclasses.replace(
                m, capacity_factor=m.num_experts / m.top_k))
            got, _ = path(card, free, x.to(dev), mesh)
            want, _ = moe.apply_dense(card, cfg, x.to(dev))
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            for fp8 in (False, True):
                own = cfg.with_(moe=dataclasses.replace(m, dispatch_fp8=fp8))
                got, aux = path(card, own, x.to(dev), mesh)
                want, want_aux = path(params, own, x, cpu_mesh)
                torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                           atol=tol)
                assert abs(float(aux) - float(want_aux)) < tol
        grads = {"a": torch.randn((33, 7), generator=gen).to(dev),
                 "b": torch.randn((5,), generator=gen).to(dev,
                                                          torch.bfloat16)}
        err = gc.init_error_state(grads)
        with dctx.mesh_context(mesh):
            mean, new_err = gc.compressed_psum_tree(grads, err, "model")
        for k, g in grads.items():
            q, scale, want_err = gc.compress(g, err[k])
            assert torch.equal(mean[k], gc.decompress(q, scale).to(g.dtype))
            assert torch.equal(new_err[k], want_err)
        w = {"w": torch.randn((1, 32, 32), generator=gen).to(dev) / 6,
             "b": torch.zeros((1, 32), device=dev)}
        x = torch.randn((16, 32), generator=gen).to(dev)
        leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
        y = pipelined(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                      make_mesh((1, 1), ("pod", "data"), devices=[dev]),
                      4)(leaves, x)
        (y ** 2).sum().backward()
        want = torch.tanh(x @ w["w"][0] + w["b"][0])
        torch.testing.assert_close(y.detach(), want, rtol=tol, atol=tol)
        torch.testing.assert_close(
            leaves["w"].grad[0], x.T @ (2 * want * (1 - want ** 2)),
            rtol=tol, atol=tol)
