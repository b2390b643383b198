"""The port's packed-layer primitives and BitLinear vs ``repro``'s.

The plain versions of the two kernels of this slice (what their wrappers
run for CPU tensors) are held bit-exact (tolerance 0) against ``repro``'s
Pallas kernels in interpret mode: ``binarize_pack`` (sign + pack) and the
unfused packed ``binary_conv2x2``.  Then the neuron array's packed paths
and BitLinear, whose inference path runs them: packed == float on +/-1
inputs, exactly, in both packages.  The CUDA kernels are held against
these plain versions on the card by ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin, binary_layers as jbl
from repro.core.chip import neuron_array as jna
from repro.kernels.binarize_pack import binarize_pack as jbinarize_pack
from repro.kernels.binary_conv2x2 import binary_conv2x2 as jbinary_conv2x2
from repro_torch import convert
from repro_torch.core import binarize as tbin, binary_layers as tbl
from repro_torch.core.chip import neuron_array as tna
from repro_torch.kernels import binarize_pack as bp
from repro_torch.kernels import binary_conv2x2 as bc
from repro_torch.kernels import ops
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401


def _signs(rng, shape):
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=shape)


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# binarize_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(1, 32), (5, 100), (300, 64), (256, 4096),
                                 (256, 960)])
def test_binarize_pack_plain_vs_pallas(m, k):
    """Normal values with 0.0, -0.0 and +/-1e-30 planted: bit 1 iff x < 0
    (so -0.0 gives 0), K padded with +1.  Exact, as words."""
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=min(flat.size, 40), replace=False)
    flat[idx] = np.resize(np.array([0.0, -0.0, 1e-30, -1e-30], np.float32),
                          idx.size)
    want = np.asarray(jbinarize_pack(jnp.asarray(x), interpret=True))
    got = ops.pack(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        bp.binarize_pack_plain(torch.from_numpy(x)).numpy().view(np.uint32),
        want)


def test_pack_takes_leading_axes_and_matches_pack_signs_on_signs():
    """ops.pack flattens (..., K) like repro's ops.pack, and on +/-1 values
    it is pack_signs."""
    rng = np.random.default_rng(1)
    x = _signs(rng, (3, 4, 5, 70))
    got = ops.pack(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 4, 5, 3)
    assert torch.equal(got, tbin.pack_signs(torch.from_numpy(x), axis=-1))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jbin.pack_signs(jnp.asarray(x), axis=-1)))


# ---------------------------------------------------------------------------
# binary_conv2x2
# ---------------------------------------------------------------------------

CASES = [
    (4, 4, 32, 8),      # tiny map
    (32, 32, 64, 64),   # chip S=4 layer shape
    (32, 32, 256, 64),  # chip S=1 layer shape (256 ch)
    (31, 31, 128, 32),  # odd spatial, S=2 channels
    (8, 9, 40, 16),     # non-square, C not multiple of 32
]


def _conv_case(rng, b, h, w, c, f):
    """Packed +/-1 maps (3-D when b is None) and taps, with their signs."""
    shape = (h, w, c) if b is None else (b, h, w, c)
    a = _signs(rng, shape)
    wt = _signs(rng, (f, 2, 2, c))
    a_words = np.asarray(jbin.pack_signs(jnp.asarray(a), axis=-1))
    w_words = np.asarray(jbin.pack_signs(jnp.asarray(wt).reshape(f, 4, c),
                                         axis=-1))
    return a, wt, a_words, w_words


@pytest.mark.parametrize("h,w,c,f", CASES)
def test_binary_conv2x2_plain_vs_pallas(h, w, c, f):
    """repro's CASES, 3-D input -> 3-D output, exact."""
    rng = np.random.default_rng(h * 100 + w * 10 + c + f)
    _, _, a_words, w_words = _conv_case(rng, None, h, w, c, f)
    want = np.asarray(jbinary_conv2x2(jnp.asarray(a_words),
                                      jnp.asarray(w_words), c=c,
                                      interpret=True))
    got = ops.binary_conv2x2(_i32(a_words), _i32(w_words), c)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,h,w,c,f", [(3, 8, 9, 40, 16), (3, 6, 6, 256, 70),
                                       (2, 2, 2, 1, 33)])
def test_binary_conv2x2_batched_plain_vs_pallas(b, h, w, c, f):
    """A batch of frames, F off the 32 grid, c = 1 and the 2x2 minimum."""
    rng = np.random.default_rng(b + h + c + f)
    _, _, a_words, w_words = _conv_case(rng, b, h, w, c, f)
    want = np.asarray(jbinary_conv2x2(jnp.asarray(a_words),
                                      jnp.asarray(w_words), c=c,
                                      interpret=True))
    got = bc.binary_conv2x2_plain(_i32(a_words), _i32(w_words), c)
    assert tuple(got.shape) == (b, h - 1, w - 1, f)
    np.testing.assert_array_equal(got.numpy(), want)


def test_binary_conv2x2_full_range_words():
    """Random words (bit 31 set in about half, every bit live): both
    versions popcount all 32 bits of every word."""
    rng = np.random.default_rng(9)
    a, w = _words(rng, (2, 5, 6, 2)), _words(rng, (40, 4, 2))
    want = np.asarray(jbinary_conv2x2(jnp.asarray(a), jnp.asarray(w), c=64,
                                      interpret=True))
    np.testing.assert_array_equal(
        ops.binary_conv2x2(_i32(a), _i32(w), 64).numpy(), want)


# ---------------------------------------------------------------------------
# The neuron array's packed paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,c,f", [(2, 8, 8, 64, 64), (1, 5, 7, 40, 24)])
def test_conv2x2_packed_equals_float_and_repro(b, h, w, c, f):
    rng = np.random.default_rng(c + f)
    x, wt, _, _ = _conv_case(rng, b, h, w, c, f)
    want = np.asarray(jna.conv2x2_packed(jnp.asarray(x), jnp.asarray(wt),
                                         interpret=True))
    got = tna.conv2x2_packed(torch.from_numpy(x), torch.from_numpy(wt))
    flt = tna.conv2x2(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, flt)


def test_fc_packed_equals_float_and_repro():
    rng = np.random.default_rng(3)
    x, wt = _signs(rng, (5, 100)), _signs(rng, (10, 100))
    want = np.asarray(jna.fc_packed(jnp.asarray(x), jnp.asarray(wt),
                                    interpret=True))
    got = tna.fc_packed(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tna.fc(torch.from_numpy(x), torch.from_numpy(wt)))


# ---------------------------------------------------------------------------
# BitLinear
# ---------------------------------------------------------------------------

def _bitlinear(rng, d_in, d_out):
    return {"w": (rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)
                  ).astype(np.float32),
            "g": (1 + 0.2 * rng.standard_normal(d_out)).astype(np.float32)}


@pytest.mark.parametrize("lead,d_in,d_out", [((2, 5), 100, 48),
                                             ((16,), 960, 64)])
def test_bitlinear_train_path_equals_repro(lead, d_in, d_out):
    """The STE path: outputs rtol 1e-6 (the einsum of +/-1 is exact; the
    scale is the same float32 expression), gradients for x, w and g
    within max(1e-4 x the JAX leaf's max abs, 1e-7)."""
    rng = np.random.default_rng(d_in)
    npp = _bitlinear(rng, d_in, d_out)
    x = (rng.standard_normal(lead + (d_in,)) * 1.2).astype(np.float32)
    gout = rng.standard_normal(lead + (d_out,)).astype(np.float32)

    def jloss(p, xx):
        y = jbl.apply_train(p, xx)
        return jnp.sum(y * jnp.asarray(gout)), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(x))
    params = {k: v.requires_grad_(True) for k, v in
              convert.bitlinear_from_numpy(npp, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tbl.apply_train(params, xt)
    (y * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6)
    for got, want in ((params["w"].grad, jgp["w"]), (params["g"].grad,
                                                      jgp["g"]),
                      (xt.grad, jgx)):
        want = np.asarray(want)
        tol = max(1e-4 * float(np.abs(want).max()), 1e-7)
        assert float(np.abs(got.numpy() - want).max()) <= tol


@pytest.mark.parametrize("lead,d_in,d_out", [((2, 5), 100, 48),
                                             ((256,), 960, 96)])
def test_bitlinear_infer_path_equals_repro_and_train_forward(lead, d_in,
                                                              d_out):
    """The packed path (binarize_pack -> xnor_matmul) equals repro's in
    Pallas interpret mode and the port's own STE forward, bit for bit."""
    rng = np.random.default_rng(d_out)
    npp = _bitlinear(rng, d_in, d_out)
    x = rng.standard_normal(lead + (d_in,)).astype(np.float32)
    x.reshape(-1)[:4] = [0.0, -0.0, 1e-30, -1e-30]
    want = np.asarray(jbl.apply_infer(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(x),
        interpret=True))
    params = convert.bitlinear_from_numpy(npp, device="cpu")
    got = tbl.apply_infer(params, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tbl.apply_train(params, torch.from_numpy(x)))


def test_bitlinear_init_shapes_and_device():
    p = tbl.init(torch.Generator().manual_seed(0), 960, 2560, device="cpu")
    assert tuple(p["w"].shape) == (2560, 960) and tuple(p["g"].shape) == (
        2560,)
    assert 0.02 < float(p["w"].std()) < 0.045             # ~ 1/sqrt(960)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbl.init(torch.Generator(), 4, 4)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    """No quiet CPU path through the CUDA wrappers, nothing launched for
    CPU tensors, and operands neither version takes raise."""
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bp.binarize_pack(torch.zeros((2, 40)))
    with pytest.raises(ValueError, match="CUDA"):
        bc.binary_conv2x2(torch.zeros((3, 3, 2), dtype=torch.int32),
                          torch.zeros((4, 4, 2), dtype=torch.int32), c=40)
    ops.pack(torch.zeros((2, 40)))
    ops.binary_conv2x2(torch.zeros((3, 3, 2), dtype=torch.int32),
                       torch.zeros((4, 4, 2), dtype=torch.int32), 40)
    ops.binary_linear(torch.zeros((2, 40)), torch.ones((3, 40)))
    assert set(ops.launch_counts().values()) == {0}
    assert {"binarize_pack", "binary_conv2x2"} <= set(ops.launch_counts())
    with pytest.raises(ValueError, match="float32"):
        ops.pack(torch.zeros((2, 40), dtype=torch.float64))
    with pytest.raises(ValueError, match="channel words"):
        ops.binary_conv2x2(torch.zeros((3, 3, 65), dtype=torch.int32),
                           torch.zeros((4, 4, 65), dtype=torch.int32), 2080)
    with pytest.raises(ValueError, match="does not fit"):
        ops.binary_conv2x2(torch.zeros((3, 3, 2), dtype=torch.int32),
                           torch.zeros((4, 4, 2), dtype=torch.int32), 65)
    with pytest.raises(ValueError, match="no conv output"):
        ops.binary_conv2x2(torch.zeros((1, 3, 2), dtype=torch.int32),
                           torch.zeros((4, 4, 2), dtype=torch.int32), 40)
