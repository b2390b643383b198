"""The port's binarization primitives vs ``repro.core.binarize``.

Every comparison is bit-exact (tolerance 0): packed words are compared as
uint32 bit patterns, thresholds as float32 bit patterns.  Inputs are made
with numpy from fixed seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jb
from repro_torch.core import binarize as tb
from tests.test_torch_interpreter import one_torch_thread  # noqa: F401


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _words(rng, shape):
    """uint32 words over the full range, with bit 31 set in about half,
    plus the extreme patterns in the first row."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:4] = [0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0]
    return w


@pytest.mark.parametrize("shape,axis", [((3, 45), -1), ((2, 70, 3), 1),
                                        ((4, 64), -1), ((5, 1), 0)])
def test_pack_signs_and_unpack(shape, axis):
    """K not a multiple of 32 pads with +1 (bit 0); unpack inverts."""
    x = _signs(np.random.default_rng(0), shape)
    want = np.asarray(jb.pack_signs(jnp.asarray(x), axis=axis))
    got = tb.pack_signs(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(_u32(got), want)
    k = shape[axis]
    back = tb.unpack_signs(got, k, axis=axis)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jb.unpack_signs(jnp.asarray(want), k,
                                                 axis=axis)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_pack_bit_lanes_lsb_first():
    bits = (np.random.default_rng(1).random((3, 96)) < 0.5)
    bits[0, 31] = bits[1, 63] = True                  # bit 31 of a word
    want = np.asarray(jb.pack_bit_lanes(jnp.asarray(bits)))
    np.testing.assert_array_equal(_u32(tb.pack_bit_lanes(
        torch.from_numpy(bits))), want)


def test_popcount_and_xnor_dot_with_bit31_words():
    """The SWAR popcount masks to 32 bits, so words with bit 31 set
    (negative as int32) count right."""
    rng = np.random.default_rng(2)
    a, w = _words(rng, (6, 5)), _words(rng, (7, 5))
    want_pc = np.array([bin(int(v)).count("1") for v in a.reshape(-1)])
    got_pc = tb.popcount32(torch.from_numpy(a.view(np.int32)))
    np.testing.assert_array_equal(got_pc.numpy().reshape(-1), want_pc)
    k = 5 * 32
    want = np.asarray(jb.xnor_dot_popcount(jnp.asarray(a)[:, None, :],
                                           jnp.asarray(w)[None], k))
    got = tb.xnor_dot_popcount(torch.from_numpy(a.view(np.int32))[:, None],
                               torch.from_numpy(w.view(np.int32))[None], k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hard_sign_ties_to_plus_one():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    np.testing.assert_array_equal(
        tb.hard_sign(torch.from_numpy(x)).numpy(),
        np.asarray(jb.hard_sign(jnp.asarray(x))))


# every IO geometry of networks.REGISTRY: (bits, cin, channels)
_IO_GEOMETRIES = [(7, 3, 256), (7, 3, 128), (7, 3, 64), (8, 1, 64)]


@pytest.mark.parametrize("bits,cin,channels", _IO_GEOMETRIES)
def test_thermometer_thresholds_and_pack(bits, cin, channels):
    """float32 thresholds are bit-identical to JAX's, and so are the
    packed thermometer words over every pixel value."""
    per = channels // cin
    want_t = ((jnp.arange(per, dtype=jnp.float32) + 0.5)
              * (2 ** bits / per))
    got_t = tb.thermometer_thresholds(bits, per)
    np.testing.assert_array_equal(got_t.numpy().view(np.uint32),
                                  np.asarray(want_t).view(np.uint32))
    px = np.arange(2 ** bits, dtype=np.int32)
    img = np.stack([np.roll(px, c) for c in range(cin)], -1)[None, None]
    want = np.asarray(jb.thermometer_pack(jnp.asarray(img), bits, cin,
                                          channels))
    got = tb.thermometer_pack(torch.from_numpy(img), bits, cin, channels)
    np.testing.assert_array_equal(_u32(got), want)


def _bn(rng, n):
    gamma = rng.standard_normal(n).astype(np.float32)
    beta = (rng.standard_normal(n) * 4).astype(np.float32)
    mean = (rng.standard_normal(n) * 30).astype(np.float32)
    var = rng.uniform(0.0, 200.0, n).astype(np.float32)
    # integer-boundary thresholds (beta = 0 -> tau = mean exactly), a
    # near-integer one, and gamma = 0 (tau = +/-inf)
    mean[:4] = [5.0, -7.0, 0.0, 12.0]
    beta[:3] = 0.0
    beta[3] = 1e-6
    gamma[4:6] = 0.0
    beta[4], beta[5] = 1.0, -1.0
    return gamma, beta, mean, var


def test_fold_bn_threshold_bit_exact():
    """float32 BN fold in repro's operation order, then ceil and clip:
    tau, its int32 form and flip all match bit for bit, including inf
    and integer-boundary thresholds."""
    gamma, beta, mean, var = _bn(np.random.default_rng(3), 4096)
    jt, jf = jb.fold_bn_to_threshold(*map(jnp.asarray, (gamma, beta, mean,
                                                        var)), eps=1e-4)
    tt, tf = tb.fold_bn_to_threshold(*map(torch.from_numpy, (gamma, beta,
                                                             mean, var)),
                                     eps=1e-4)
    np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.isinf(tt.numpy()).sum() == 2
    np.testing.assert_array_equal(tb.threshold_to_int(tt).numpy(),
                                  np.asarray(jb.threshold_to_int(jt)))
    np.testing.assert_array_equal(tb.threshold_to_int(tt).numpy()[:3],
                                  [5, -7, 0])


def test_threshold_activation():
    rng = np.random.default_rng(4)
    s = rng.integers(-40, 40, (5, 16)).astype(np.float32)
    tau = rng.integers(-40, 40, 16).astype(np.float32)
    tau[0] = s[0, 0]                                   # s == tau fires
    flip = rng.random(16) < 0.5
    want = np.asarray(jb.threshold_activation(jnp.asarray(s),
                                              jnp.asarray(tau),
                                              jnp.asarray(flip)))
    got = tb.threshold_activation(torch.from_numpy(s), torch.from_numpy(tau),
                                  torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), want)
