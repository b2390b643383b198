"""The port's training meshes and partition specs against ``repro``'s, on
the CPU.

* ``sharding.param_specs``, ``batch_specs``, ``cache_specs`` and
  ``steps.state_specs`` (adamw and adafactor) for all ten configs at full
  width on the pod (16 x 16) and multipod (2 x 16 x 16) meshes: leaf by
  leaf, as axis-name tuples, equal to ``repro``'s on
  ``jax.sharding.AbstractMesh`` (no devices).
* Each leaf's shard shape, from its DTensor placements on a
  ``DeviceMesh`` under a ``fake`` process group of 256 or 512 ranks, on
  meta tensors, equal to the shape ``repro``'s spec and the mesh sizes
  give; one process group at a time, torn down after each test.
* The mesh builders, ``mesh_context``, ``data_axes``,
  ``model_axis_size``, ``constrain`` (the identity without a mesh or on
  one device, a redistributed DTensor on several), and one SmolLM
  ``scaled()`` training step on a one-rank CPU group under the host mesh
  equal, bit for bit, to the same step without a mesh (the card's twin is
  in ``test_torch_gpu.py``).
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.distributed import context as jctx
from repro.distributed import sharding as jshd
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.data import tokens
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttf
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

ARCHS = list(jreg.ARCH_IDS)
MESHES = ("pod", "multipod")
OPTIMIZERS = ("adamw", "adafactor")


def _jmesh(name):
    return AbstractMesh((2, 16, 16) if name == "multipod" else (16, 16),
                        ("pod", "data", "model") if name == "multipod"
                        else ("data", "model"))


def _lr(mod):
    return mod.cosine_schedule(3e-4, warmup=100, total=10000)


def _jleaves(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    return sorted((jshd._path_str(p), tuple(s)) for p, s in flat)


def _tleaves(spec_tree):
    return sorted((p, tuple(s)) for p, s in shd.leaves_with_path(spec_tree))


def _trees(arch, mesh_name, optimizer):
    """repro's and the port's spec trees of one config on one mesh:
    {what: (repro's, the port's)}."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jm, tm = _jmesh(mesh_name), dryrun.production_mesh(mesh_name)
    train, decode = jshapes.SHAPES["train_4k"], jshapes.SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jtf.init_cache(
        jcfg, decode.global_batch, decode.seq_len))
    tcache = ttf.init_cache(tcfg, decode.global_batch, decode.seq_len,
                            device="meta")
    tdecode = tshapes.SHAPES["decode_32k"]
    return {
        "state": (jsteps.state_specs(jcfg, jm, jopt.make(optimizer,
                                                         _lr(jopt))),
                  tsteps.state_specs(tcfg, tm, topt.make(optimizer,
                                                         _lr(topt)))),
        "train batch": (
            jshd.batch_specs(jcfg, jm, jshapes.input_specs(jcfg, train)),
            shd.batch_specs(tcfg, tm, tshapes.input_specs(
                tcfg, tshapes.SHAPES["train_4k"]))),
        "decode batch": (
            jshd.batch_specs(jcfg, jm, jshapes.input_specs(jcfg, decode)),
            shd.batch_specs(tcfg, tm, tshapes.input_specs(tcfg, tdecode))),
        "cache": (jshd.cache_specs(jcfg, jm, jcache),
                  shd.cache_specs(tcfg, tm, tcache)),
    }


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_repros(arch, mesh_name, optimizer):
    for what, (want, got) in _trees(arch, mesh_name, optimizer).items():
        want, got = _jleaves(want), _tleaves(got)
        assert [p for p, _ in got] == [p for p, _ in want], what
        for (path, w), (_, g) in zip(want, got):
            assert g == w, f"{what} {path}: {g} != {w}"
    # the parameters' specs alone, as param_specs gives them
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jparams = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    assert _tleaves(shd.param_specs(
        tcfg, dryrun.production_mesh(mesh_name),
        ttf.init_params(tcfg, device="meta"))) == _jleaves(
            jshd.param_specs(jcfg, _jmesh(mesh_name), jparams))


def _want_shard(shape, spec, sizes):
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n = math.prod(sizes[a] for a in axes)
        assert dim % n == 0
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_under_a_fake_group_equal_repros_arithmetic(
        arch, mesh_name):
    """Every leaf of the train state (the config's optimizer, as the dry
    run builds it) and the decode cache, distributed on meta under a fake
    group of the mesh's size: this rank's shard is the shape repro's spec
    gives."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jm = _jmesh(mesh_name)
    sizes = dict(jm.shape)
    want = {}
    jo = jopt.make(jcfg.optimizer, _lr(jopt))     # the dry run's
    jstate = jsteps.state_shape(jcfg, jo)
    jspecs = jsteps.state_specs(jcfg, jm, jo)
    flat_shapes = dict((jshd._path_str(p), tuple(x.shape)) for p, x in
                       jax.tree_util.tree_flatten_with_path(jstate)[0])
    for path, spec in _jleaves(jspecs):
        want["state/" + path] = _want_shard(flat_shapes[path], spec, sizes)
    decode = jshapes.SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jtf.init_cache(
        jcfg, decode.global_batch, decode.seq_len))
    flat_shapes = dict((jshd._path_str(p), tuple(x.shape)) for p, x in
                       jax.tree_util.tree_flatten_with_path(jcache)[0])
    for path, spec in _jleaves(jshd.cache_specs(jcfg, jm, jcache)):
        want["cache/" + path] = _want_shard(flat_shapes[path], spec, sizes)
    mesh = dryrun.production_mesh(mesh_name)
    trees = dryrun.argument_trees(tcfg, tshapes.SHAPES["train_4k"], mesh)
    assert set(trees) == {"params", "optimizer_state", "batch"}
    tstate = {"params": trees["params"][0], **trees["optimizer_state"][0]}
    tspecs = {"params": trees["params"][1], **trees["optimizer_state"][1]}
    got = {}
    with dctx.fake_process_group(mesh.size):
        dmesh = shd.device_mesh(mesh)
        assert dmesh.size() == mesh.size
        named = dict(shd.leaves_with_path(shd.to_named(mesh, tspecs, dmesh)))
        for path, leaf in shd.leaves_with_path(tstate):
            got["state/" + path] = tuple(
                named[path].distribute(leaf).to_local().shape)
        cache = ttf.init_cache(tcfg, decode.global_batch, decode.seq_len,
                               device="meta")
        cspecs = shd.cache_specs(tcfg, mesh, cache)
        for (path, leaf), (_, spec) in zip(shd.leaves_with_path(cache),
                                           shd.leaves_with_path(cspecs)):
            sharding = shd.to_named(mesh, spec, dmesh)
            got["cache/" + path] = sharding.shard_shape(leaf.shape)
    assert not dist_initialized()
    assert got.keys() == want.keys() and got == want


def dist_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_initialized()


def test_production_meshes_are_abstract_only_by_name():
    pod = tmesh.make_production_mesh(abstract=True)
    multi = tmesh.make_production_mesh(multi_pod=True, abstract=True)
    for got, name in ((pod, "pod"), (multi, "multipod")):
        assert got.is_abstract and got.devices is None
        assert dict(got.shape) == dict(_jmesh(name).shape)
        assert got.axis_names == _jmesh(name).axis_names
        assert list(got.shape) == list(got.axis_names)
    assert pod.size == 256 and multi.size == 512
    # no silent swap: without 256 devices the concrete mesh raises
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    m = tmesh.make_mesh_for(8, 2, abstract=True)
    assert dict(m.shape) == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh_for(3, 2, abstract=True)


def test_host_mesh_needs_a_card_or_named_devices():
    host = tmesh.make_host_mesh(devices=["cpu"])
    assert not host.is_abstract and host.size == 1
    assert dict(host.shape) == {"data": 1, "model": 1}
    assert host.devices.flat[0] == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()
    restart = ckpt.make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    assert dict(restart.shape) == {"data": 2, "model": 1}


@pytest.mark.parametrize("name", MESHES)
def test_axes_helpers_equal_repros(name):
    jm, tm = _jmesh(name), dryrun.production_mesh(name)
    assert dctx.data_axes(tm) == jctx.data_axes(jm)
    assert dctx.model_axis_size(tm) == jctx.model_axis_size(jm) == 16
    assert dctx.model_axis_size(None) == jctx.model_axis_size(None) == 1


def test_mesh_context_nests_and_restores():
    pod, multi = (dryrun.production_mesh(n) for n in MESHES)
    assert dctx.current_mesh() is None
    with dctx.mesh_context(pod) as m:
        assert m is pod and dctx.current_mesh() is pod
        with dctx.mesh_context(multi):
            assert dctx.current_mesh() is multi
            with dctx.mesh_context(None):
                assert dctx.current_mesh() is None
            assert dctx.current_mesh() is multi
        assert dctx.current_mesh() is pod
        with pytest.raises(KeyError):
            with dctx.mesh_context(multi):
                raise KeyError("inside")
        assert dctx.current_mesh() is pod
    assert dctx.current_mesh() is None


def test_constrain_is_the_identity_without_a_mesh_or_on_one_device():
    x = torch.randn(4, 6, 8)
    assert shd.constrain(x, ("dp", None, "tp")) is x
    with dctx.mesh_context(tmesh.make_host_mesh(devices=["cpu"])):
        assert shd.constrain(x, ("dp", None, "tp")) is x
    with dctx.mesh_context(dryrun.production_mesh("pod")):
        assert shd.constrain(x, ("dp", "tp")) is x       # ranks differ
        with pytest.raises(TypeError, match="DTensor"):
            shd.constrain(x, ("dp", None, "tp"))


def test_constrain_redistributes_a_dtensor_on_a_mesh():
    """A replicated (256, 64, 10) DTensor on the pod mesh, constrained to
    ('dp', 'tp', 'tp'): batch over data, 64 over model, 10 (not divisible
    by 16) replicated, as repro's rule gives."""
    mesh = dryrun.production_mesh("pod")
    with dctx.fake_process_group(mesh.size):
        dmesh = shd.device_mesh(mesh)
        x = shd.to_named(mesh, shd.P(None, None, None), dmesh).distribute(
            torch.empty(256, 64, 10, device="meta"))
        with dctx.mesh_context(mesh):
            y = shd.constrain(x, ("dp", "tp", None))
        assert tuple(y.to_local().shape) == (16, 4, 10)
        assert y.placements == shd.placements(shd.P("data", "model", None),
                                              mesh)


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = dryrun.production_mesh("multipod")
    assert shd.placements(shd.P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements(shd.P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert shd.placements(shd.P(), mesh) == (Replicate(),) * 3
    for bad in (shd.P(("data", "pod")), shd.P("model", "model")):
        with pytest.raises(ValueError, match="mesh order"):
            shd.placements(bad, mesh)
    assert shd.P(("data",), ()) == ("data", None)      # PartitionSpec's rule
    assert tuple(JP(("data",), ())) == ("data", None)


def test_one_rank_step_under_the_host_mesh_equals_the_step_without():
    """SmolLM scaled(), one adamw step of 2 x 16 on a one-rank CPU group:
    every leaf's shard is the whole leaf, and the step under
    ``mesh_context(make_host_mesh())`` equals the step outside it, bit for
    bit."""
    cfg = treg.get_config("smollm-360m").scaled()
    optimizer = topt.make("adamw", _lr(topt))
    batch = tokens.batch_for_step(cfg, 0, global_batch=2, seq_len=16,
                                  device="cpu")
    mesh = tmesh.make_host_mesh(devices=["cpu"])
    step = tsteps.build_train_step(cfg, optimizer)

    def run():
        state = tsteps.create_state(cfg, 0, optimizer, device="cpu")
        return step(state, batch)

    with dctx.local_process_group():
        specs = tsteps.state_specs(cfg, mesh, optimizer)
        named = dict(shd.leaves_with_path(shd.to_named(mesh, specs)))
        shapes = tsteps.state_shape(cfg, optimizer)
        for path, leaf in shd.leaves_with_path(shapes):
            assert named[path].shard_shape(leaf.shape) == tuple(leaf.shape)
        with dctx.mesh_context(mesh):
            inside, m_in = run()
    outside, m_out = run()
    assert not dist_initialized()
    for (path, a), (_, b) in zip(shd.leaves_with_path(inside),
                                 shd.leaves_with_path(outside)):
        assert torch.equal(a, b), path
    assert torch.equal(m_in["loss"], m_out["loss"])
    assert np.isfinite(float(m_in["loss"]))
