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
    """The flash-attention kernel vs its plain version at five small shapes
    (G = 3 with a ragged S, whose 16-row fragments straddle positions; G = 4
    with D = 128; MQA with D = 128, not causal; the scaled() configs' head
    dims 32 and 16, the latter not causal), in both types and every
    probability type: within 2e-5 where the chain is float32 throughout,
    3e-2 where p or the output is bf16 (repro's tolerances), and at a given
    probability type ten times closer on the mean to the plain version at
    that type than at the other; a head dim of 8 raises.  Prefills of a
    small SmolLM-shaped model through the kernel, float32 and bf16, launch
    it once per layer and match the chunked forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    gen = torch.Generator().manual_seed(11)
    for b, s, h, kh, d, causal in ((2, 77, 6, 2, 64, True),
                                   (1, 96, 16, 4, 128, True),
                                   (1, 130, 8, 1, 128, False),
                                   (2, 70, 6, 2, 32, True),
                                   (1, 90, 4, 4, 16, False)):
        qkv = [torch.randn(shape, generator=gen) for shape in
               ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype).cuda() for x in qkv)
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
    # a head dim the kernel lacks is refused on the card, not rerouted
    q = torch.zeros((1, 8, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="head dim 8"):
        fa.flash_attention(q, q, q)
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
