"""The port's kernel modules vs ``repro``'s Pallas kernels.

The plain PyTorch versions (what every kernel wrapper runs for CPU
tensors) are held bit-exact (tolerance 0) against ``repro``'s kernels run
as ``repro``'s own tests run them, in Pallas interpret mode.  The CUDA
kernels themselves are held against these plain versions on the card by
``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jb
from repro.core.chip import interpreter as jinterp, networks as jnets
from repro.kernels import binary_conv2x2_block as jbcb
from repro.kernels import xnor_matmul as jxm
from repro_torch import convert
from repro_torch.core.chip import interpreter as tinterp, networks as tnets
from repro_torch.kernels import binary_conv2x2_block as bcb
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops
from repro_torch.kernels import xnor_matmul as xm
from tests.test_torch_interpreter import np_params, one_torch_thread  # noqa: F401


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _conv_case(rng, b, h, w, c):
    a = _words(rng, (b, h, w, c // 32))
    wt = _words(rng, (c, 4, c // 32))
    tau = rng.integers(-4 * c, 4 * c + 1, c).astype(np.int32)
    tau[:2] = [-2 ** 31, 2 ** 31 - 256]               # saturated neurons
    flip = rng.integers(0, 2, c).astype(np.int32)
    return a, wt, tau, flip


# S=4 8x8, S=2 9x7, S=1 6x6 (C = F = 256/S), each with and without pool
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(2, 8, 8, 64), (2, 9, 7, 128),
                                     (1, 6, 6, 256)])
def test_conv_block_plain_vs_pallas(b, h, w, c, pool):
    a, wt, tau, flip = _conv_case(np.random.default_rng(c + pool), b, h, w, c)
    want = np.asarray(jbcb.binary_conv2x2_block(
        jnp.asarray(a), jnp.asarray(wt), jnp.asarray(tau), jnp.asarray(flip),
        c=c, pool=pool, interpret=True))
    got = ops.binary_conv2x2_block(_i32(a), _i32(wt), torch.from_numpy(tau),
                                   torch.from_numpy(flip), c, pool=pool)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("pack_out", [False, True])
def test_xnor_matmul_plain_vs_pallas(pack_out):
    """K = 100 leaves a tail word whose padding bits are zero on both
    sides; K = 96 uses full-range words (bit 31 set in about half)."""
    rng = np.random.default_rng(5)
    m, n = 5, 64

    def packed(rows):
        signs = np.where(rng.random((rows, 100)) < 0.5, -1.0, 1.0)
        return np.asarray(jb.pack_signs(jnp.asarray(signs), axis=-1))

    cases = [(100, packed(m), packed(n)),
             (96, _words(rng, (m, 3)), _words(rng, (n, 3)))]
    for k, a, w in cases:
        want = np.asarray(jxm.xnor_matmul(jnp.asarray(a), jnp.asarray(w), k=k,
                                          pack_out=pack_out, interpret=True))
        got = ops.xnor_matmul(_i32(a), _i32(w), k, pack_out=pack_out)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32) if pack_out else got.numpy(), want)


def test_megakernel_plain_vs_pallas_mnist5():
    """The plain megakernel vs repro's forward_mega in interpret mode,
    mnist5 at B=3: int32 logits and labels."""
    name = "mnist5"
    jprog, tprog = jnets.REGISTRY[name](), tnets.REGISTRY[name]()
    npp = np_params(jprog, seed=11)
    jimage = jinterp.fold_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 jprog, image=True)
    io = jprog.instrs[0]
    frames = np.random.default_rng(12).integers(
        0, 2 ** io.bits, (3, io.height, io.width, io.in_channels),
        dtype=np.int32)
    want_l, want_y = jinterp.compile_plan(jprog).forward_mega(
        jimage, jnp.asarray(frames), interpret=True)
    image = convert.artifact_from_numpy(
        {k: np.asarray(v) for k, v in jimage.items()}, device="cpu")
    plan = tinterp.compile_plan(tprog)
    raw = ops.megakernel_forward(image, torch.from_numpy(frames),
                                 spec=plan.mega)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), np.asarray(want_l))
    got_l, got_y = plan.forward_mega(image, frames, device="cpu")
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_cuda_wrappers_refuse_cpu_tensors():
    """No quiet CPU path: the kernel wrappers take CUDA tensors only (the
    dispatch in ops sends CPU tensors to the plain versions), and ops
    launches nothing for CPU tensors."""
    a = torch.zeros((2, 3, 3, 2), dtype=torch.int32)
    w = torch.zeros((64, 4, 2), dtype=torch.int32)
    t = torch.zeros(64, dtype=torch.int32)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bcb.binary_conv2x2_block(a, w, t, t, c=64)
    with pytest.raises(ValueError, match="CUDA"):
        xm.xnor_matmul(torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros((32, 2), dtype=torch.int32), 64)
    prog = tnets.REGISTRY["mnist5"]()
    image = tinterp.build_weight_image(
        tinterp.fold_params(tinterp.init_params(
            torch.Generator().manual_seed(0), prog, device="cpu"), prog,
            packed=True), prog)
    with pytest.raises(ValueError, match="CUDA"):
        mk.megakernel_forward(image, torch.zeros((1, 14, 14, 1)),
                              spec=tinterp.compile_plan(prog).mega)
    ops.binary_conv2x2_block(a, w, t, t, 64)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="F % 32"):
        ops.binary_conv2x2_block(a, w[:48], t[:48], t[:48], 64)
    with pytest.raises(ValueError, match="N % 32"):
        ops.xnor_matmul(torch.zeros((2, 2), dtype=torch.int32),
                        torch.zeros((10, 2), dtype=torch.int32), 64,
                        pack_out=True)
