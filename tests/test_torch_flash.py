"""The port's flash-attention plain version vs ``repro``'s Pallas kernel
and chunked attention.

``flash_attention_plain`` (what ``ops.flash_attention`` runs for CPU
tensors) is held against ``repro.kernels.flash_attention.
flash_attention_fwd`` run in Pallas interpret mode, as ``repro``'s own
tests run it, and against ``repro.models.attention.chunked_attention``,
on inputs made from a numpy seed.  Tolerances are ``repro``'s: 2e-5 in
float32 and 3e-2 in bfloat16 (the two round p to bf16 at the same place
but sum in other orders).  Interpret-mode cases stay at S <= 128.  Head
dims off the kernel's instantiations (8 and 20, the ``scaled()`` configs
of kimi-k2, qwen1.5-110b and musicgen-medium) are held the same way, and
the kernel's rule for them (the next instantiation up, zero columns past
d, d columns stored, the scale of the true d) is held on the plain version
and the launcher's helpers.  The CUDA kernel is held against the plain
version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.models.attention import chunked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _plain(qkv, dtype, causal):
    out = ops.flash_attention(*(_torch(x, dtype) for x in qkv),
                              causal=causal)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


# (b, s, h, kh, d, Pallas block_q, block_k, causal, dtype)
CASES = {
    "mha": (1, 128, 4, 4, 16, 64, 64, True, "float32"),
    "gqa_g2": (2, 128, 4, 2, 16, 32, 64, True, "float32"),
    "smollm_g3_d64": (1, 128, 6, 2, 64, 64, 64, True, "float32"),
    "mqa": (1, 64, 8, 1, 32, 64, 32, True, "float32"),
    "non_causal": (2, 128, 4, 2, 16, 64, 64, False, "float32"),
    "bf16": (1, 128, 4, 2, 16, 64, 64, True, "bfloat16"),
    # head dims the kernel pads: kimi-k2's and qwen1.5-110b's scaled() 8
    # (G = 2), musicgen-medium's 20 (MHA), causal and not, both types
    "d8_gqa": (2, 128, 4, 2, 8, 64, 64, True, "float32"),
    "d8_bf16": (1, 128, 4, 2, 8, 64, 64, True, "bfloat16"),
    "d20_mha": (1, 128, 4, 4, 20, 64, 64, True, "float32"),
    "d20_non_causal_bf16": (2, 64, 6, 2, 20, 32, 64, False, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    b, s, h, kh, d, bq, bk, causal, dtype = CASES[case]
    qkv = _qkv(len(case), b, s, h, kh, d)
    want = flash_attention_fwd(*(_jax(x, dtype) for x in qkv), causal=causal,
                               block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(_plain(qkv, dtype, causal),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_chunked_attention(case):
    b, s, h, kh, d, _, _, causal, dtype = CASES[case]
    qkv = _qkv(len(case) + 100, b, s, h, kh, d)
    want = chunked_attention(*(_jax(x, dtype) for x in qkv), causal=causal,
                             chunk_q=64, chunk_k=64)
    np.testing.assert_allclose(_plain(qkv, dtype, causal),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# S not a multiple of the 64-key tile (repro's kernel asserts divisibility)
@pytest.mark.parametrize("s,h,kh,causal", [(1, 3, 1, True), (37, 6, 2, True),
                                           (100, 15, 5, True),
                                           (70, 4, 2, False)])
def test_plain_ragged_length_matches_chunked_attention(s, h, kh, causal):
    qkv = _qkv(s, 2, s, h, kh, 64)
    want = chunked_attention(*(jnp.asarray(x) for x in qkv), causal=causal,
                             chunk_q=32, chunk_k=32)
    np.testing.assert_allclose(_plain(qkv, "float32", causal),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


# bf16 at SmolLM's head layout: the plain version rounds p to bf16 before
# p.v, as chunked_attention does with probs_bf16 (repro's 3e-2).  Without
# probs_bf16 chunked_attention keeps p in float32 (SmolLM-360M's config);
# the two then differ by at most U * max|v| (p's rounding, U = 2**-8 for
# bf16) plus half an ulp of each output's bf16 rounding (U * |out| each).
U_BF16 = 2.0 ** -8


@pytest.mark.parametrize("probs_bf16", [True, False])
def test_plain_bf16_against_chunked_probability_types(probs_bf16):
    qkv = _qkv(11, 1, 128, 15, 5, 64)
    got = _plain(qkv, "bfloat16", True)
    want = np.asarray(chunked_attention(
        *(_jax(x, "bfloat16") for x in qkv), causal=True, chunk_q=64,
        chunk_k=64, probs_bf16=probs_bf16), np.float32)
    err = float(np.abs(got - want).max())
    if probs_bf16:
        assert err <= TOL["bfloat16"]
    else:
        v = np.asarray(_jax(qkv[2], "bfloat16"), np.float32)
        bound = U_BF16 * (np.abs(v).max() + 2 * (1 + U_BF16)
                          * np.abs(want).max()) + 1e-5
        assert 0 < err <= bound


# the probability type (probs_bf16 of chunked_attention, which the LM's
# attention passes from cfg.attn_probs_bf16): the plain version at either
# setting against chunked_attention at the same one, (b, s, h, kh, d): G=3
# at D=64, G=4 at D=128, and ragged S (37 with G=3, 100 at SmolLM's heads)
PROB_SHAPES = {"g3_d64": (2, 64, 6, 2, 64), "g4_d128": (1, 64, 8, 2, 128),
               "ragged37": (2, 37, 6, 2, 64), "ragged100": (1, 100, 15, 5, 64)}


@pytest.mark.parametrize("probs_bf16", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(PROB_SHAPES))
def test_plain_matches_chunked_attention_at_probability_type(shape, dtype,
                                                             probs_bf16):
    b, s, h, kh, d = PROB_SHAPES[shape]
    qkv = _qkv(s + d, b, s, h, kh, d)
    got = ops.flash_attention(*(_torch(x, dtype) for x in qkv), causal=True,
                              probs_bf16=probs_bf16)
    assert got.dtype == getattr(torch, dtype)
    want = chunked_attention(*(_jax(x, dtype) for x in qkv), causal=True,
                             chunk_q=32, chunk_k=32, probs_bf16=probs_bf16)
    # float32 throughout only for float32 inputs with float32 probabilities
    tol = TOL["bfloat16" if probs_bf16 else dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", sorted(PROB_SHAPES))
def test_float32_probabilities_separate_from_bf16_on_the_mean(shape):
    """The two probability types differ by a few bf16 ulps at most, inside
    3e-2, so the max error cannot tell them apart; the mean can.  In bf16,
    float32 p sits more than ten times closer on the mean to chunked
    attention with float32 p than to it with bf16 p, and bf16 p (what a
    version ignoring the setting would give) does not: the rule
    ``chip_smoke.py`` holds the kernel to."""
    b, s, h, kh, d = PROB_SHAPES[shape]
    qkv = _qkv(s + d + 1, b, s, h, kh, d)
    want = {p: torch.from_numpy(np.asarray(chunked_attention(
        *(_jax(x, "bfloat16") for x in qkv), causal=True, chunk_q=32,
        chunk_k=32, probs_bf16=p), np.float32)) for p in (True, False)}

    def means(got):
        return [float((got.float() - want[p]).abs().mean())
                for p in (False, True)]

    q, k, v = (_torch(x, "bfloat16") for x in qkv)
    same, other = means(fa.flash_attention_plain(q, k, v, probs_bf16=False))
    assert same * 10 < other
    same, other = means(fa.flash_attention_plain(q, k, v, probs_bf16=True))
    assert not same * 10 < other


def test_probability_type_none_rounds_p_to_v_type():
    qkv = [_torch(x, "bfloat16") for x in _qkv(3, 1, 70, 6, 2, 64)]
    for dtype, same in ((torch.bfloat16, True), (torch.float32, False)):
        q, k, v = (x.to(dtype) for x in qkv)
        want = fa.flash_attention_plain(q, k, v, probs_bf16=same)
        assert torch.equal(fa.flash_attention_plain(q, k, v), want)
        assert not torch.equal(
            fa.flash_attention_plain(q, k, v, probs_bf16=not same), want)


def test_cpu_path_launches_nothing_and_kernel_wants_cuda():
    q, k, v = (_torch(x, "float32") for x in _qkv(0, 1, 16, 2, 1, 64))
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "groups", "len"])
def test_inputs_neither_version_takes_raise(bad):
    q, k, v = (_torch(x, "float32") for x in _qkv(1, 1, 16, 4, 2, 64))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "rank":
        q = q[0]
    elif bad == "groups":
        q = torch.cat([q, q[:, :, :1]], dim=2)            # H = 5, KH = 2
    else:
        k, v = k[:, :8], v[:, :8]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# head dims off the instantiations: the kernel's padding rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 8, 15, 20, 33, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_to_the_instantiation_keeps_the_output(d, causal):
    """What the kernel does at a head dim d between its instantiations,
    on the plain version: q, k and v zero-padded to ``kernel_dim(d)``
    columns, the scale of the true d, the first d output columns kept,
    equal to the plain version at d (the zeros add nothing to q.k, the
    padded columns of p.v are zeros and are dropped)."""
    dk = fa.kernel_dim(d)
    assert dk in fa.HEAD_DIMS and dk >= d and (dk == 16 or dk // 2 < d)
    q, k, v = (torch.from_numpy(x) for x in _qkv(d, 2, 70, 6, 2, d))
    padded = [torch.nn.functional.pad(x, (0, dk - d)) for x in (q, k, v)]
    got = fa.flash_attention_plain(*padded, causal=causal,
                                   scale=1.0 / math.sqrt(d))
    assert got.shape[-1] == dk and not got[..., d:].any()
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    # the scale of the padded dim is another function: the trap
    wrong = fa.flash_attention_plain(*padded, causal=causal)[..., :d]
    assert d == dk or not torch.allclose(wrong, want, atol=1e-3)


def test_kernel_dims_and_copy_widths():
    assert [fa.kernel_dim(d) for d in (1, 8, 16, 17, 20, 32, 64, 65, 128)] \
        == [16, 16, 16, 32, 32, 32, 64, 128, 128]
    for bad in (0, 129, 256):
        with pytest.raises(ValueError, match="1 to 128"):
            fa.kernel_dim(bad)
    # a row of d bf16 is 2 d bytes: the widest copy dividing it and every
    # pointer (D = 20: 40-byte rows take 8-byte copies)
    assert fa.copy_bytes(64, 0, 16) == 16 and fa.copy_bytes(20, 0, 0) == 8
    assert fa.copy_bytes(8, 0, 0) == 16 and fa.copy_bytes(64, 0, 8) == 8
    assert fa.copy_bytes(7, 0) == 2 and fa.copy_bytes(6, 0, 4) == 4
    for d in range(1, 129):
        for ptrs in ((0, 0), (0, 2), (4, 8), (16, 48)):
            w = fa.copy_bytes(d, *ptrs)
            assert 2 * d % w == 0 and all(p % w == 0 for p in ptrs)


def test_launcher_matches_the_c_entry_point():
    """The C entry point's dispatch names exactly ``HEAD_DIMS`` for both
    types and its ctypes declaration carries every argument in order."""
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    for sign in ("", "-"):
        cases = [int(c) for c in re.findall(
            rf"case {sign}(\d+):\s+return launch_(?:bf16|f32)<\1>", src)]
        assert tuple(cases) == fa.HEAD_DIMS
    sig = re.search(r'extern "C" int flash_attention_launch\(([^)]*)\)',
                    src).group(1)
    types = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [types.get(p.split()[0], ctypes.c_void_p)
            for p in sig.replace("\n", " ").split(",")]
    assert fa.ARGTYPES == want


def test_kernel_refuses_head_dims_past_the_limit():
    q, k, v = (torch.zeros(1, 4, 2, 129) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v)          # the device is checked first
    with pytest.raises(ValueError, match="1 to 128"):
        fa.kernel_dim(q.shape[-1])


def test_flop_formula_counts_the_true_head_dim():
    """The op's registered FLOPs at d = 20 are those of d = 20, not of the
    instantiation the kernel pads to."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 16, 4, 4, 20))
    with FlopCounterMode(display=False) as counter:
        ops.flash_attention(q, k, v, causal=True)
    assert counter.get_total_flops() == fa.attention_flops(1, 16, 4, 20,
                                                           True)
