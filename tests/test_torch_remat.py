"""``cfg.remat`` in the port's training step (``models/transformer.py``
``forward``: each repeat of the pattern under ``torch.utils.checkpoint``,
as ``repro`` wraps its scan body in ``jax.checkpoint``), on the CPU, at
``scaled()`` sizes with ``remat`` turned back on.

* The scaled SmolLM-360M step's FLOPs against ``repro``'s ``hlo_cost``
  count of its own step at ``remat=True``, within ``STEP_VS_HLO``
  (``tests/test_torch_cost.py``); the recompute lowers the step's peak
  live bytes below the ``remat=False`` step's.
* The float32 train step at ``remat=True`` == the same step at
  ``remat=False``, bit for bit (the loss and every leaf of the new
  state): the recompute runs the same ops on the same values.
* The step at ``remat=True`` against ``repro``'s at ``remat=True``:
  ``tests/test_torch_train_lm.py``'s whole-step tolerances.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from repro.data import tokens as jtok
from repro.launch import hlo_cost
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttok
from repro_torch.distributed import context as dctx
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_cost
from repro_torch.models import transformer
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps
from test_torch_cost import B, S, STEP_VS_HLO
from test_torch_train_lm import _cfgs, _hold_step, _one_step

META = torch.device("meta")
ARCHS = ("smollm-360m", "jamba-v0.1-52b", "rwkv6-3b")


def _cfg(arch, remat):
    return treg.get_config(arch).scaled().with_(
        dtype="float32", param_dtype="float32", loss_chunk=16, remat=remat)


def _counts(remat):
    """The scaled SmolLM step (``test_torch_cost``'s shapes), counted on
    the CPU and on meta."""
    cfg = _cfg("smollm-360m", remat)
    to = topt.make(cfg.optimizer, topt.cosine_schedule(1e-3, 10, 100))
    step = tsteps.build_train_step(cfg, to)
    batch = ttok.batch_for_step(cfg, 0, global_batch=B, seq_len=S,
                                device="cpu")
    on_cpu = op_cost.count(step, tsteps.create_state(cfg, 0, to,
                                                     device="cpu"), batch)
    on_meta = op_cost.count(
        step, tsteps.state_shape(cfg, to),
        {k: torch.empty_like(v, device=META) for k, v in batch.items()})
    return on_cpu, on_meta


def test_remat_step_counts_near_repros_and_lowers_the_peak():
    jcfg, _ = _cfgs(loss_chunk=16, remat=True)
    jbatch = jtok.batch_for_step(jcfg, 0, global_batch=B, seq_len=S)
    jo = jopt.make(jcfg.optimizer, jopt.cosine_schedule(1e-3, 10, 100))
    lowered = jax.jit(jsteps.build_train_step(jcfg, jo)).lower(
        jsteps.state_shape(jcfg, jo),
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                     jbatch))
    want = hlo_cost.analyze_text(lowered.compile().as_text())
    got, on_meta = _counts(True)
    kept, _ = _counts(False)
    print(f"scaled SmolLM step at remat=True: port {got.flops:.4e} FLOPs "
          f"(remat=False {kept.flops:.4e}), repro {want.flops:.4e} (ratio "
          f"{got.flops / want.flops:.4f}); peak bytes {got.peak_bytes:.4e} "
          f"(remat=False {kept.peak_bytes:.4e})")
    assert got.flops == pytest.approx(want.flops, rel=STEP_VS_HLO)
    assert got.flops > kept.flops            # the forward runs again
    assert got.peak_bytes < kept.peak_bytes
    assert (on_meta.flops, on_meta.bytes, on_meta.peak_bytes) == (
        got.flops, got.bytes, got.peak_bytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_equals_the_kept_step_bit_for_bit(arch):
    out = {}
    for remat in (False, True):
        cfg = _cfg(arch, remat)
        to = topt.make(cfg.optimizer, topt.cosine_schedule(1e-3, 2, 10))
        batch = ttok.batch_for_step(cfg, 0, global_batch=2, seq_len=32,
                                    device="cpu")
        out[remat] = tsteps.build_train_step(cfg, to)(
            tsteps.create_state(cfg, 0, to, device="cpu"), batch)
    (kept, km), (remat, rm) = out[False], out[True]
    assert torch.equal(km["loss"], rm["loss"])
    assert torch.equal(km["grad_norm"], rm["grad_norm"])
    a, b = topt.tree_leaves(kept), topt.tree_leaves(remat)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert np.isfinite(float(rm["loss"]))


def test_remat_step_matches_repros_remat_step():
    jcfg, tcfg = _cfgs(remat=True)
    assert jcfg.remat and tcfg.remat
    jnew, jm, tnew, tm, jgrads, _, _ = _one_step("adamw", jcfg, tcfg)
    _hold_step(jnew, jm, tnew, tm, jgrads)


def test_recompute_on_another_thread_sees_the_steps_mesh(monkeypatch):
    """On the card autograd runs the backward, the recompute with it, in
    a thread of its own: the recomputed repeats and CE chunks run under
    the mesh the step was called under (``context.under_current_mesh``),
    not the other thread's none.  Here the backward is sent to another
    thread as CUDA sends it."""
    cfg = _cfg("smollm-360m", True)
    mesh = tmesh.make_host_mesh(devices=["cpu"])
    seen = []
    for mod, name in ((transformer, "block_apply"), (tsteps, "_ce_chunk")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=real, **k: (
            seen.append(dctx.current_mesh()), _f(*a, **k))[1])
    grad = torch.autograd.grad

    def on_a_thread(*a, **k):
        out = {}
        t = threading.Thread(target=lambda: out.update(g=grad(*a, **k)))
        t.start()
        t.join()
        return out["g"]
    monkeypatch.setattr(torch.autograd, "grad", on_a_thread)
    to = topt.make(cfg.optimizer, topt.cosine_schedule(1e-3, 2, 10))
    batch = ttok.batch_for_step(cfg, 0, global_batch=2, seq_len=32,
                                device="cpu")
    with dctx.mesh_context(mesh):
        tsteps.build_train_step(cfg, to)(
            tsteps.create_state(cfg, 0, to, device="cpu"), batch)
    forward = cfg.num_layers + 32 // cfg.loss_chunk
    assert len(seen) == 2 * forward          # each run again
    assert all(m is mesh for m in seen)
