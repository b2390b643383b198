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
  one full-width cell through ``main``, and RWKV6-3B's and Jamba's
  ``train_4k`` cells through ``main`` (their recurrences scaled by
  ``op_cost.scan``).
* ``--mesh pod`` and ``--mesh multipod``: each record's chips, each
  category's bytes on one device equal to the arithmetic of ``repro``'s
  spec trees on its abstract meshes, ``step_counted: true`` with
  ``repro``'s keys (one device's share of the sharded step counted:
  ``tests/test_torch_sharded_cost.py`` holds the counts themselves);
  every multipod cell SKIPPED where ``repro`` skips it, the decode and
  long-context ones counted.
* The card records of SmolLM-360M's three OK cells and of RWKV6-3B's and
  Jamba's ``train_4k``: FLOPs and bytes as the tree before the sharded
  count gave them, to the last digit.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jshd
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
    assert (rec["hlo_flops"], rec["hlo_bytes"]) == CARD[("smollm-360m",
                                                          "decode_32k")]
    assert "1 cells: 1 ok" in capsys.readouterr().out


def _jbytes_per_device(tree, specs, mesh) -> int:
    """One device's bytes of a tree of ShapeDtypeStructs under repro's
    spec tree: each dim divided by the product of its axes' sizes."""
    specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), specs):
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            div = math.prod(mesh.shape[a] for a in axes)
            assert dim % div == 0
            n *= dim // div
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _repro_per_device(arch, shape_name, mesh):
    """repro's dry-run arguments of a cell by category, in bytes a
    device."""
    cfg = jreg.get_config(arch)
    shape = jshapes.SHAPES[shape_name]
    batch = jshapes.input_specs(cfg, shape)
    want = dict.fromkeys(dryrun.CATEGORIES, 0)
    if shape.step == "train":
        jo = jopt.make(cfg.optimizer,
                       jopt.cosine_schedule(3e-4, warmup=100, total=10000))
        state = jsteps.state_shape(cfg, jo)
        specs = jsteps.state_specs(cfg, mesh, jo)
        want["params"] = _jbytes_per_device(state["params"],
                                            specs["params"], mesh)
        want["optimizer_state"] = sum(
            _jbytes_per_device(state[k], specs[k], mesh)
            for k in ("opt_state", "step"))
        want["batch"] = _jbytes_per_device(
            batch, jshd.batch_specs(cfg, mesh, batch), mesh)
        return want
    params = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    want["params"] = _jbytes_per_device(
        params, jshd.param_specs(cfg, mesh, params), mesh)
    cache = jax.eval_shape(lambda: jtf.init_cache(cfg, shape.global_batch,
                                                  shape.seq_len))
    want["cache"] = _jbytes_per_device(
        cache, jshd.cache_specs(cfg, mesh, cache), mesh)
    tok = list(batch.values())[0]
    want["batch"] = _jbytes_per_device(
        tok, jshd.batch_specs(cfg, mesh, {"t": tok})["t"], mesh)
    return want


# these cases replace one that held --mesh pod|multipod to raise: they
# count one device's share of the sharded step now (and still record its
# arguments' bytes a device)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_mesh_cells_record_per_device_argument_bytes(mesh, shape, tmp_path,
                                                     capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--mesh", mesh, "--arch", "smollm-360m", "--shape",
                     shape, "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / f"dryrun_smollm-360m__{shape}__{mesh}.json")
                     .read_text())
    jmesh = AbstractMesh((2, 16, 16) if mesh == "multipod" else (16, 16),
                         ("pod", "data", "model") if mesh == "multipod"
                         else ("data", "model"))
    chips = 512 if mesh == "multipod" else 256
    assert rec["status"] == "OK" and rec["mesh"] == mesh
    assert rec["chips"] == chips and rec["step_counted"] is True
    want = _repro_per_device("smollm-360m", shape, jmesh)
    assert rec["argument_bytes_per_device"] == want
    assert rec["bytes_per_chip"]["argument"] == sum(want.values())
    assert rec["bytes_per_chip"]["output"] > 0
    assert rec["bytes_per_chip"]["temp"] > 0
    assert (want["cache"] > 0) == (shape == "decode_32k")
    assert (want["optimizer_state"] > 0) == (shape == "train_4k")
    # one device's FLOPs x chips: at least the card's whole step (every
    # device does at least its share), at most chips times it
    card = CARD[("smollm-360m", shape)][0]
    assert card <= rec["hlo_flops"] <= card * chips
    # the breakdown's kinds are whole bytes, their sum the exact total
    assert rec["coll_bytes_per_chip"] == pytest.approx(
        sum(rec["coll_breakdown"].values()), abs=5)
    assert rec["coll_breakdown"]["all-reduce"] > 0
    assert rec["t_collective"] > 0 and rec["trace_s"] < 1200
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline_fraction"] <= 1
    assert "1 cells: 1 ok" in capsys.readouterr().out
    import torch.distributed as dist
    assert not dist.is_initialized()            # torn down after the cell


def test_every_multipod_cell_is_ok_or_skipped(tmp_path, capsys):
    """Every one of the 40 cells on the 512-chip mesh is SKIPPED where
    cell_supported says so; the decode_32k and long_500k cells of every
    arch run through main and count their sharded step (the train and
    prefill cells take 3-130 s each on meta: the whole 80-cell sweep is
    the dry run's own command, PERF.md's tables)."""
    for arch in ARCHS:
        for shape in jshapes.SHAPES:
            rec = dryrun.skipped(dryrun.cell_config(arch), arch, shape,
                                 "multipod")
            ok, _ = jshapes.cell_supported(jreg.get_config(arch), shape)
            assert (rec is None) == ok, (arch, shape)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--mesh", "multipod", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--mesh", "multipod", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "10 cells: 10 ok, 0 skipped, 0 failed" in out
    assert "10 cells: 2 ok, 8 skipped, 0 failed" in out
    recs = [json.loads(f.read_text()) for f in tmp_path.glob("*.json")]
    assert len(recs) == 20
    for rec in recs:
        if rec["status"] == "OK":
            assert rec["chips"] == 512 and rec["step_counted"] is True
            assert rec["bytes_per_chip"]["argument"] > 0
            assert rec["hlo_flops"] > 0 and rec["coll_bytes_per_chip"] > 0
            assert rec["trace_s"] < 1200


# the card records' FLOPs and bytes (launch/dryrun.py on meta): the
# prefill and decode as the tree before the sharded count gave them
# (counting DTensors leaves every plain step's charges as they were, to
# the last digit); the training steps with each pattern repeat recomputed
# in the backward (cfg.remat, as repro: 1.25-1.33x the FLOPs they counted
# without it); RWKV-6's recurrence scanning its inputs as lax.scan's xs
# (1.114x the FLOPs and 2.243x the bytes while each token's step indexed
# them itself, its backward a gradient of their whole shape a token)
CARD = {("smollm-360m", "train_4k"): (4219651623422924.0,
                                      280845510863450.0),
        ("smollm-360m", "prefill_32k"): (2771463780234336.0,
                                         6525640981388.0),
        ("smollm-360m", "decode_32k"): (614123758944.0, 1277658475276.0),
        ("rwkv6-3b", "train_4k"): (2.4772200685602884e+16,
                                   1.810345380384165e+16),
        ("jamba-v0.1-52b", "train_4k"): (4.351414623417602e+17,
                                         7.62072226345809e+16)}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_smollm_card_records_are_unchanged(shape):
    rec = dryrun.lower_cell("smollm-360m", shape)
    assert (rec["hlo_flops"], rec["hlo_bytes"]) == CARD[("smollm-360m",
                                                          shape)]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_recurrent_train_4k_cell_ends_ok(arch, tmp_path, capsys):
    """The per-token recurrences' training cells at full width, which ran
    every one of their 4096 iterations a layer before op_cost.scan and
    outlasted 1200 s: OK, their recurrence counted once and scaled."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", arch, "--shape", "train_4k", "--out",
                     str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / f"dryrun_{arch}__train_4k__card.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["bottleneck"] == "memory"
    assert rec["hlo_flops"] > rec["model_flops"] > 0
    assert (rec["hlo_flops"], rec["hlo_bytes"]) == CARD[(arch, "train_4k")]
    assert rec["trace_s"] < 300
    assert "1 cells: 1 ok" in capsys.readouterr().out


def test_collective_sites_sum_to_the_breakdown(tmp_path, capsys):
    """``--collective-sites N``: the record's ``coll_sites`` (every
    collective's wire bytes by kind and the frame that issued it) sum to
    the cell's ``coll_breakdown`` kind by kind, and each kind's N largest
    sites are printed under the cell's line; without the flag the record
    has none."""
    args = ["--mesh", "pod", "--arch", "smollm-360m", "--shape",
            "decode_32k", "--out", str(tmp_path)]
    for flag in ([], ["--collective-sites", "2"]):
        with pytest.raises(SystemExit) as done:
            dryrun.main(args + flag)
        assert done.value.code == 0
        rec = json.loads((tmp_path / "dryrun_smollm-360m__decode_32k__pod"
                                     ".json").read_text())
        assert ("coll_sites" in rec) == bool(flag)
    out = capsys.readouterr().out
    sites = rec["coll_sites"]
    for kind, want in rec["coll_breakdown"].items():
        got = sum(s["wire_bytes"] for s in sites if s["kind"] == kind)
        assert got == pytest.approx(want, rel=1e-12, abs=0), kind
        rows = [s for s in sites if s["kind"] == kind]
        assert len([line for line in out.splitlines()
                    if line.startswith(f"    {kind} ")]) == min(2, len(rows))
    assert sites and all(s["site"].startswith(("models/", "train/"))
                         for s in sites)
