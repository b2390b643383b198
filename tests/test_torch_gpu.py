"""Each CUDA kernel of the port vs its plain PyTorch version, on the card.

Needs a CUDA device and the CUDA toolkit; skips without a device.  It
imports neither JAX nor ``repro``, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Every comparison is bit-exact (tolerance 0), at main-path shapes;
``chip_smoke.py`` runs the full set.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.chip import interpreter, networks
from repro_torch.kernels import binary_conv2x2_block as bcb
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import xnor_matmul as xm
from repro_torch.launch import chip_serve
from repro_torch.serving.server import ChipServer


def _words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for b, h, w, c, pool in ((8, 32, 32, 256, False), (5, 29, 29, 256, True),
                             (3, 14, 14, 64, True), (2, 9, 7, 128, False)):
        a, wt = _words(rng, b, h, w, c // 32), _words(rng, c, 4, c // 32)
        tau = torch.from_numpy(rng.integers(-4 * c, 4 * c + 1, c,
                                            dtype=np.int32))
        tau[:2] = torch.tensor([-2 ** 31, 2 ** 31 - 256])
        flip = torch.from_numpy(rng.integers(0, 2, c, dtype=np.int32))
        want = bcb.conv_block_body(a, wt, tau, flip, k4=4 * c, h=h, wd=w,
                                   pool=pool)
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
