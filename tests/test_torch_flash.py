"""The port's flash-attention plain version vs ``repro``'s Pallas kernel
and chunked attention.

``flash_attention_plain`` (what ``ops.flash_attention`` runs for CPU
tensors) is held against ``repro.kernels.flash_attention.
flash_attention_fwd`` run in Pallas interpret mode, as ``repro``'s own
tests run it, and against ``repro.models.attention.chunked_attention``,
on inputs made from a numpy seed.  Tolerances are ``repro``'s: 2e-5 in
float32 and 3e-2 in bfloat16 (the two round p to bf16 at the same place
but sum in other orders).  Interpret-mode cases stay at S <= 128.  The
CUDA kernel is held against the plain version on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

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
