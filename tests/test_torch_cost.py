"""The port's cost model (``launch/op_cost.py``, ``launch/roofline.py``
and the flash-attention dispatcher op) against ``repro``'s
(``launch/hlo_cost.py``, ``launch/roofline.py``), on the CPU.

Each case of ``tests/test_hlo_cost.py`` runs here twice: ``repro``'s
function through ``hlo_cost.analyze_text`` of its compiled HLO, and the
same function written in PyTorch through ``op_cost.count``, with the
band stated at each case.  ``repro`` scans its loops where the port runs
them eagerly; ``hlo_cost`` scales a scanned body by its trip count and
``op_cost`` counts every iteration, so the two meet on the loops.

The SmolLM training step is where the two programs differ most: XLA
fuses the elementwise chains, the port runs each op as its own kernel.
Its FLOPs are held to ``tests/test_hlo_cost.py``'s 6ND band and, beside
it, to ``repro``'s count within ``STEP_VS_HLO`` (the reason is there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.configs.base import active_param_count as j_active
from repro.configs.base import param_count as j_param_count
from repro.data import tokens as jtok
from repro.launch import hlo_cost
from repro.launch import roofline as jroof
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.base import active_param_count as t_active
from repro_torch.data import tokens as ttok
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as troof
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

META = torch.device("meta")
# The port's FLOPs of the scaled SmolLM step against repro's hlo_cost count
# of the same step, relative.  Fusion does not move FLOPs (hlo_cost counts
# the instructions inside a fusion at the same 1 a element), and both
# recompute the CE chunks' logits in the backward (jax.checkpoint,
# torch.utils.checkpoint), so what is left is op for op: the eager
# chunked attention's masks and rescales against XLA's simplified
# graph, softmax and RMSNorm decomposed differently, adamw's ops a leaf.
# Measured 0.991 (port / repro); 5% holds that and would catch any
# missed product (one layer's matmuls are ~40% of the step at this size).
# Bytes are not compared: XLA's fusions keep their inner traffic on
# chip, the eager ops do not.
STEP_VS_HLO = 0.05


def _hlo(fn, *args):
    c = jax.jit(fn).lower(*args).compile()
    return hlo_cost.analyze_text(c.as_text())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py's cases
# ---------------------------------------------------------------------------

def test_dot_flops_exact():
    want = _hlo(lambda a, b: a @ b,
                jax.ShapeDtypeStruct((64, 256), jnp.float32),
                jax.ShapeDtypeStruct((256, 128), jnp.float32))
    got = op_cost.count(lambda a, b: a @ b, _meta(64, 256), _meta(256, 128))
    assert got.flops == 2 * 64 * 256 * 128 == want.flops
    # operands and output once each, as hlo_cost charges a dot
    assert got.bytes == (64 * 256 + 256 * 128 + 64 * 128) * 4 == want.bytes


def test_batched_bf16_einsum_flops():
    want = _hlo(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                jax.ShapeDtypeStruct((4, 64, 256), jnp.bfloat16),
                jax.ShapeDtypeStruct((4, 256, 128), jnp.bfloat16))
    got = op_cost.count(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                        _meta(4, 64, 256, dtype=torch.bfloat16),
                        _meta(4, 256, 128, dtype=torch.bfloat16))
    assert got.flops == pytest.approx(want.flops, rel=0.02)
    assert got.flops == 2 * 4 * 64 * 256 * 128


def test_python_loop_equals_repros_scan():
    """12 eager iterations against repro's scanned program, whose body
    hlo_cost scales by the trip count."""
    t = 12

    def scanned(x, ws):
        c, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), ()), x, ws)
        return c

    def loop(x, ws):
        for i in range(t):
            x = torch.tanh(x @ ws[i])
        return x

    want = _hlo(scanned, jax.ShapeDtypeStruct((128, 128), jnp.float32),
                jax.ShapeDtypeStruct((t, 128, 128), jnp.float32))
    got = op_cost.count(loop, _meta(128, 128), _meta(t, 128, 128))
    assert got.flops == pytest.approx(want.flops, rel=0.05)
    # bytes: each iteration reads its (128, 128) slice, not the stack;
    # repro's band for its scanned bytes (2x)
    assert got.bytes == pytest.approx(want.bytes, rel=1.0)


def test_nested_loop_within_repros_band():
    to, ti = 5, 7

    def inner(c, w):
        return c * w + 1.0, ()

    def outer(c, ws):
        c2, _ = jax.lax.scan(inner, c, ws)
        return c2, ()

    def scanned(x, ws):
        c, _ = jax.lax.scan(outer, x, ws)
        return c

    def loop(x, ws):
        for i in range(to):
            for j in range(ti):
                x = x * ws[i, j] + 1.0
        return x

    want = _hlo(scanned, jax.ShapeDtypeStruct((256,), jnp.float32),
                jax.ShapeDtypeStruct((to, ti, 256), jnp.float32))
    got = op_cost.count(loop, _meta(256), _meta(to, ti, 256))
    assert got.flops == pytest.approx(want.flops, rel=1.0)
    assert got.flops == 2 * to * ti * 256       # a mul and an add a step


def test_stacked_outputs_bytes_not_quadratic():
    """A loop stacking its per-step outputs is charged the slices it
    reads and writes, not the whole stack a step."""
    t, n = 64, 1024

    def scanned(x, ws):
        _, ys = jax.lax.scan(lambda c, w: (c + 1.0, c * w), x, ws)
        return ys

    def loop(x, ws):
        ys = []
        for i in range(t):
            ys.append(x * ws[i])
            x = x + 1.0
        return torch.stack(ys)

    want = _hlo(scanned, jax.ShapeDtypeStruct((n,), jnp.float32),
                jax.ShapeDtypeStruct((t, n), jnp.float32))
    got = op_cost.count(loop, _meta(n), _meta(t, n))
    stacked = t * n * 4
    for b in (got.bytes, want.bytes):
        assert 2 * stacked <= b < 12 * stacked, b


def test_broadcast_operand_charged_by_its_storage():
    """An expanded view is charged the bytes it spans in its storage."""
    x = _meta(1, 512)
    got = op_cost.count(lambda a, b: a.expand(256, 512) + b, x,
                        _meta(256, 512))
    assert got.flops == 256 * 512
    assert got.bytes == (512 + 2 * 256 * 512) * 4


# ---------------------------------------------------------------------------
# a training step
# ---------------------------------------------------------------------------

B, S = 4, 64


def _smollm_step_counts():
    jcfg = jreg.get_config("smollm-360m").scaled().with_(
        dtype="float32", param_dtype="float32", loss_chunk=16)
    tcfg = treg.get_config("smollm-360m").scaled().with_(
        dtype="float32", param_dtype="float32", loss_chunk=16)
    jbatch = jtok.batch_for_step(jcfg, 0, global_batch=B, seq_len=S)
    jo = jopt.make(jcfg.optimizer, jopt.cosine_schedule(1e-3, 10, 100))
    lowered = jax.jit(jsteps.build_train_step(jcfg, jo)).lower(
        jsteps.state_shape(jcfg, jo),
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                     jbatch))
    want = hlo_cost.analyze_text(lowered.compile().as_text())
    to = topt.make(tcfg.optimizer, topt.cosine_schedule(1e-3, 10, 100))
    step = tsteps.build_train_step(tcfg, to)
    batch = ttok.batch_for_step(tcfg, 0, global_batch=B, seq_len=S,
                                device="cpu")
    on_cpu = op_cost.count(step, tsteps.create_state(tcfg, 0, to,
                                                     device="cpu"), batch)
    on_meta = op_cost.count(
        step, tsteps.state_shape(tcfg, to),
        {k: torch.empty_like(v, device=META) for k, v in batch.items()})
    return jcfg, tcfg, want, on_cpu, on_meta


@pytest.fixture(scope="module")
def smollm_counts():
    return _smollm_step_counts()


def test_train_step_flops_near_6nd_and_repros(smollm_counts):
    jcfg, tcfg, want, got, _ = smollm_counts
    model_flops = 6 * j_param_count(jcfg) * B * S
    assert 0.5 * model_flops < got.flops < 12 * model_flops
    print(f"scaled SmolLM step: port {got.flops:.4e} FLOPs, repro "
          f"{want.flops:.4e} (ratio {got.flops / want.flops:.4f}), 6ND "
          f"{model_flops:.4e}; bytes port {got.bytes:.4e}, repro "
          f"{want.bytes:.4e} (ratio {got.bytes / want.bytes:.2f})")
    assert got.flops == pytest.approx(want.flops, rel=STEP_VS_HLO)
    assert got.coll_wire_bytes == 0
    assert got.coll_breakdown == {k: 0.0 for k in hlo_cost._COLLECTIVES}


def test_train_step_counts_equal_on_meta_and_cpu(smollm_counts):
    _, _, _, on_cpu, on_meta = smollm_counts
    assert on_meta.flops == on_cpu.flops
    assert on_meta.bytes == on_cpu.bytes
    assert on_meta.argument_bytes == on_cpu.argument_bytes
    assert on_meta.output_bytes == on_cpu.output_bytes
    # the state's parameters, adamw's m and v and the batch are live from
    # the start; the step's new state and activations come on top
    assert on_cpu.peak_bytes > on_cpu.argument_bytes + on_cpu.output_bytes


def test_peak_bytes_follow_the_live_tensors():
    def fn(x):
        y = x * 2.0            # +4 KB
        z = y + 1.0            # +4 KB
        del y                  # -4 KB
        return z.sum()         # +4 B
    got = op_cost.count(fn, torch.zeros(1024))
    assert got.argument_bytes == 4096
    assert got.peak_bytes == 3 * 4096
    assert got.output_bytes == 4


# ---------------------------------------------------------------------------
# the flash-attention dispatcher op
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, h, kh, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                 dtype=np.float32)).to(dtype)
            for n in (h, kh, kh)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_fake_shape_and_type(dtype):
    q, k, v = (t.to(META) for t in _qkv(0, 2, 40, 6, 2, 16, dtype))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.device == META and out.shape == q.shape
    assert out.dtype == dtype
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :8], v[:, :8])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_flop_formula(causal):
    b, s, h, kh, d = 4, 512, 16, 16, 128
    q, k, v = (_meta(b, s, n, d, dtype=torch.bfloat16) for n in (h, kh, kh))
    got = op_cost.count(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal), q, k, v)
    pairs = s * (s + 1) // 2 if causal else s * s
    assert got.flops == 4 * b * h * d * pairs == fa.attention_flops(
        b, s, h, d, causal)
    if causal:       # PERF.md row 10 at OLMoE's prefill: 4.303 GFLOP
        assert round(got.flops / 1e9, 3) == 4.303
    assert got.bytes == 4 * b * s * h * d * 2       # q, k, v, out


@pytest.mark.parametrize("probs_bf16", [None, False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_on_cpu_is_the_plain_version(dtype, probs_bf16):
    q, k, v = _qkv(3, 2, 77, 6, 2, 32, dtype)
    ops.reset_launch_counts()
    for causal in (True, False):
        got = torch.ops.repro_torch.flash_attention(q, k, v, causal, None,
                                                    probs_bf16)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        probs_bf16=probs_bf16)
        assert torch.equal(got, want)
        assert torch.equal(ops.flash_attention(
            q, k, v, causal=causal, probs_bf16=probs_bf16), want)
    assert ops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_at_repros_constants_equals_repros():
    kw = dict(arch="smollm-360m", shape="train_4k", mesh="pod", chips=256,
              hlo_flops=3.1e18, hlo_bytes=7.7e15, coll_bytes_per_chip=2.2e10,
              coll_breakdown={k: 0 for k in jroof._COLLECTIVES},
              model_flops=2.2e18, bytes_per_chip_peak=3.3e10)
    want = jroof.Roofline(**kw)
    got = troof.Roofline(**kw, peak_flops=jroof.PEAK_FLOPS,
                         hbm_bw=jroof.HBM_BW, link_bw=jroof.ICI_BW)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.row() == want.row()
    fields = {f.name for f in dataclasses.fields(jroof.Roofline)}
    assert fields <= {f.name for f in dataclasses.fields(troof.Roofline)}


def test_roofline_peak_follows_the_compute_type():
    cost = op_cost.ModuleCost(989e12, 3.35e12, 0.0,
                              {k: 0.0 for k in op_cost.COLLECTIVES}, 0.0)
    kw = dict(arch="a", shape="s", mesh_name="card", chips=1,
              model_flops=989e12)
    bf16 = troof.analyze(cost, dtype=torch.bfloat16, **kw)
    assert bf16.t_compute == pytest.approx(1.0)
    assert bf16.t_memory == pytest.approx(1.0)
    assert bf16.roofline_fraction == pytest.approx(1.0)
    f32 = troof.analyze(cost, dtype="float32", **kw)
    assert f32.peak_flops == 67e12 and f32.bottleneck == "compute"
    assert troof.compute_type("float32") == "float32"   # TF32 not allowed
    assert troof.compute_type(torch.float16) == "float16"


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_model_flops_for_equals_repros(shape):
    for arch in jreg.ARCH_IDS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        assert t_active(tcfg) == j_active(jcfg)
        assert (troof.model_flops_for(tcfg, tshapes.SHAPES[shape],
                                      t_active(tcfg))
                == jroof.model_flops_for(jcfg, jshapes.SHAPES[shape],
                                         j_active(jcfg)))


# ---------------------------------------------------------------------------
# trip counts: op_cost.scan on meta, scaled, against the eager loop
# ---------------------------------------------------------------------------

# A scaled scan's peak is an upper bound: it holds the iterations it did
# not run until the middle iteration's backward, where the eager loop frees
# them one at a time.  At these sizes the two have come out equal.
PEAK_BAND = 1.05


def _zeros_on_cpu(tree):
    """Zeros on the CPU in a meta tree's shapes and types (the counter
    reads shapes, strides and types alone)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _zeros_on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_on_cpu(v) for v in tree)
    return tree


def _assert_scaled_equals_eager(meta, cpu):
    assert meta.flops == cpu.flops
    assert meta.bytes == cpu.bytes
    assert meta.output_bytes == cpu.output_bytes
    assert cpu.peak_bytes <= meta.peak_bytes <= PEAK_BAND * cpu.peak_bytes


@pytest.mark.parametrize("n", [1, 4, 5, 12])
@pytest.mark.parametrize("grad", [False, True])
def test_scan_on_meta_counts_as_the_eager_loop(n, grad):
    """A toy recurrence with a captured input read a step at a time and
    a carry read twice: the scaled count (n > 4) on meta equals every
    iteration run on the CPU, the backward included; the outputs keep
    their full shapes."""
    def fn(w, xs, c0):
        def step(c, t):
            y = torch.tanh(c @ w + xs[:, t])
            return c * 0.5 + y, y * c
        c, ys = op_cost.scan(step, c0, n, dim=1)
        assert ys.shape == (xs.shape[0], n, w.shape[1]) and c.shape == c0.shape
        if grad:
            torch.autograd.grad((ys * ys).sum() + c.sum(), (w, xs))
        return ys

    def args(device):
        return (torch.zeros(16, 16, device=device, requires_grad=grad),
                torch.zeros(3, n, 16, device=device, requires_grad=grad),
                torch.zeros(3, 16, device=device))
    _assert_scaled_equals_eager(op_cost.count(fn, *args("meta")),
                                op_cost.count(fn, *args("cpu")))


@pytest.mark.parametrize("n", [5, 12])
def test_scan_under_a_recompute_counts_as_the_eager_loop(n):
    """The toy recurrence under ``torch.utils.checkpoint``, its gradient
    taken: the forward keeps nothing of the scan, the recompute in the
    backward all of it until the middle iteration's backward.  Scaled on
    meta == eager on the CPU, the peak within PEAK_BAND (the iterations
    not run were once charged again by the recompute and never
    released)."""
    from torch.utils.checkpoint import checkpoint

    def fn(w, xs, c0):
        def loop(w, xs, c0):
            def step(c, t):
                y = torch.tanh(c @ w + xs[:, t])
                return c * 0.5 + y, y * c
            return op_cost.scan(step, c0, n, dim=1)
        c, ys = checkpoint(loop, w, xs, c0, use_reentrant=False,
                           preserve_rng_state=False)
        torch.autograd.grad((ys * ys).sum() + c.sum(), (w, xs))
        return ys

    def args(device):
        return (torch.zeros(64, 64, device=device, requires_grad=True),
                torch.zeros(8, n, 64, device=device, requires_grad=True),
                torch.zeros(8, 64, device=device))
    _assert_scaled_equals_eager(op_cost.count(fn, *args("meta")),
                                op_cost.count(fn, *args("cpu")))


@pytest.mark.parametrize("n", [4, 5, 12])
def test_scan_over_xs_counts_as_the_eager_loop(n):
    """Inputs scanned as ``xs`` (one read by the output, one only by the
    carry, so its last slice gets no gradient): scaled on meta == eager
    on the CPU; the gradients equal the loop's that indexes the captured
    inputs itself, whose backward makes a gradient of their whole shape
    a step, so it moves more bytes than the stack of slices."""
    def fn(w, xs, zs, c0, scanned=True):
        def step(c, t, x=None, z=None):
            x = xs[:, t] if x is None else x
            z = zs[:, t] if z is None else z
            return c * z + x, torch.tanh(c @ w + x)
        c, ys = op_cost.scan(step, c0, n, dim=1,
                             xs=(xs, zs) if scanned else ())
        return torch.autograd.grad((ys * ys).sum() + c.sum(), (w, xs, zs))

    def args(device):
        g = torch.Generator().manual_seed(n)
        return (torch.randn(16, 16, generator=g).to(device).requires_grad_(),
                torch.randn(3, n, 16, generator=g).to(device)
                .requires_grad_(),
                torch.rand(3, n, 16, generator=g).to(device)
                .requires_grad_(),
                torch.randn(3, 16, generator=g).to(device))
    eager = op_cost.count(fn, *args("cpu"))
    _assert_scaled_equals_eager(op_cost.count(fn, *args("meta")), eager)
    for got, want in zip(fn(*args("cpu")), fn(*args("cpu"), scanned=False)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if n > 4:
        indexed = op_cost.count(lambda *a: fn(*a, scanned=False),
                                *args("cpu"))
        assert eager.bytes < indexed.bytes


def test_scan_without_a_counter_is_the_plain_loop():
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 9, 4)).astype(np.float32))

    def step(c, t):
        return c * 0.9 + xs[:, t], torch.sin(c)
    c, ys = op_cost.scan(step, torch.ones(2, 4), 9, dim=1)
    want_c, want = torch.ones(2, 4), []
    for t in range(9):
        want_c, y = step(want_c, t)
        want.append(y)
    assert torch.equal(c, want_c) and torch.equal(ys, torch.stack(want, 1))


# (arch, overrides, seq): RWKV-6 per token and chunked (chunk 16: 8 chunks
# at seq 128), and Jamba's Mamba layers, at scaled() width
RECURRENT_CELLS = [("rwkv6-3b", {}, 32), ("rwkv6-3b", {}, 128),
                   ("rwkv6-3b", {"rwkv_chunk": 16}, 128),
                   ("jamba-v0.1-52b", {}, 64)]


@pytest.mark.parametrize("step", ["train", "prefill", "decode",
                                  "train_remat"])
@pytest.mark.parametrize("arch,overrides,seq", RECURRENT_CELLS)
def test_scaled_recurrent_steps_count_as_eager(arch, overrides, seq, step):
    """The per-token recurrences' steps on meta (scaled) against the same
    steps' every iteration on CPU tensors: FLOPs and bytes exactly, the
    training step's backward included (with ``remat``, each pattern
    repeat's recurrences recomputed in the backward); peaks within
    PEAK_BAND."""
    from repro_torch.launch import dryrun
    cfg = dryrun.cell_config(arch, overrides).scaled().with_(
        remat=step == "train_remat")
    step = step.split("_")[0]
    shape = tshapes.ShapeSpec(f"{step}_small", seq, 2, step)
    fn, args = dryrun.step_and_args(cfg, shape)
    _assert_scaled_equals_eager(op_cost.count(fn, *args),
                                op_cost.count(fn, *_zeros_on_cpu(args)))


def test_a_mamba_block_with_its_backward_counts_as_eager():
    """One Mamba block with a state, its gradient taken to the parameters
    and x: scaled on meta == eager on the CPU."""
    from repro_torch.models import mamba
    cfg = treg.get_config("jamba-v0.1-52b").scaled()

    def fn(params, x, state):
        y, (conv, h) = mamba.apply(params, cfg, x, state=state)
        leaves = [p for p in topt.tree_leaves(params) if p.requires_grad]
        torch.autograd.grad((y * y).sum() + h.sum(), leaves + [x])
        return y

    def args(device):
        p = topt.tree_map(lambda t: t.requires_grad_(),
                          mamba.init(torch.Generator().manual_seed(0), cfg,
                                     device=device))
        return (p, torch.zeros(2, 96, cfg.d_model, device=device,
                               requires_grad=True),
                mamba.init_state(cfg, 2, device=device))
    _assert_scaled_equals_eager(op_cost.count(fn, *args("meta")),
                                op_cost.count(fn, *args("cpu")))
