"""The port's dry run (``launch/dryrun.py``) and its meta trees against
``repro``'s, on the CPU.

* ``init_params``, ``init_cache`` (at ``decode_32k``) and
  ``steps.state_shape`` on meta at full width, for all ten configs: the
  leaf paths, shapes and dtypes of ``repro``'s ``jax.eval_shape`` of the
  same, exactly.
* ``count_cell`` on every arch's ``scaled()`` config at small train,
  prefill and decode shapes: OK, and the same counts on CPU tensors as
  on meta (the counter reads shapes, strides and types only).
* The 40 cells' SKIPPED statuses against ``repro``'s ``cell_supported``,
  one full-width cell through ``main``, and the meshes it refuses.
"""

import json

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import dryrun, op_cost
from repro_torch.models import transformer as ttf
from repro_torch.train import steps as tsteps

ARCHS = list(jreg.ARCH_IDS)
# small cells for the scaled() configs: (step, seq_len, batch)
SMALL = (("train", 16, 2), ("prefill", 16, 2), ("decode", 16, 2))


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(k), tuple(v.shape),
             str(v.dtype).removeprefix("torch.")) for k, v in flat]


def _all_meta(tree):
    return all(t.device.type == "meta" for t in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_equal_repros_eval_shape(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    shape = jshapes.SHAPES["decode_32k"]
    want = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = ttf.init_params(tcfg, device="meta")
    assert _all_meta(got) and _leaves(got) == _leaves(want)
    want = jax.eval_shape(lambda: jtf.init_cache(jcfg, shape.global_batch,
                                                 shape.seq_len))
    got = ttf.init_cache(tcfg, shape.global_batch, shape.seq_len,
                         device="meta")
    assert _all_meta(got) and _leaves(got) == _leaves(want)
    jo = jopt.make(jcfg.optimizer,
                   jopt.cosine_schedule(3e-4, warmup=100, total=10000))
    want = jsteps.state_shape(jcfg, jo)
    got = tsteps.state_shape(tcfg, dryrun.build_optimizer(tcfg))
    assert _all_meta(got) and _leaves(got) == _leaves(want)


def _on_cpu(tree):
    """Zeros on the CPU in ``tree``'s shapes and types (token 0, position
    0: nothing the counter reads depends on the values)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_cells_count_ok_and_equal_on_meta_and_cpu(arch):
    cfg = treg.get_config(arch).scaled()
    for step, seq, batch in SMALL:
        shape = tshapes.ShapeSpec(f"{step}_small", seq, batch, step)
        rec = dryrun.count_cell(cfg, shape, arch)
        assert rec["status"] == "OK" and rec["mesh"] == "card"
        assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
        assert rec["t_collective"] == 0 and rec["chips"] == 1
        assert rec["useful_flops_ratio"] > 0
        assert rec["bytes_per_chip"]["temp"] > 0
        step_fn, args = dryrun.step_and_args(cfg, shape)
        on_cpu = op_cost.count(step_fn, *_on_cpu(args))
        assert on_cpu.flops == rec["hlo_flops"], step
        assert on_cpu.bytes == rec["hlo_bytes"], step
        assert on_cpu.output_bytes == rec["bytes_per_chip"]["output"], step


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_cell_statuses_equal_repros_support(shape):
    for arch in ARCHS:
        ok, reason = jshapes.cell_supported(jreg.get_config(arch), shape)
        rec = dryrun.skipped(dryrun.cell_config(arch), arch, shape)
        assert (rec is None) == ok, arch
        if not ok:
            assert rec == dryrun.lower_cell(arch, shape)
            assert rec["status"] == "SKIPPED" and rec["reason"] == reason


def test_main_writes_a_full_width_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "dryrun_smollm-360m__decode_32k__card.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["bottleneck"] == "memory"
    assert rec["compute_type"] == "bfloat16"
    # the KV cache alone: 32 layers x (k, v) x 128 x 32768 x 5 x 64 bf16
    kv = 32 * 2 * 128 * 32768 * 5 * 64 * 2
    assert rec["bytes_per_chip"]["argument"] > kv
    assert rec["hlo_bytes"] > kv
    assert "1 cells: 1 ok" in capsys.readouterr().out


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_meshes_of_several_cards_raise(mesh):
    with pytest.raises(SystemExit, match="5.5"):
        dryrun.main(["--mesh", mesh, "--arch", "smollm-360m"])
