"""The port's ChipServer vs ``repro``'s on one seeded mnist5 trace.

Labels per request and the served/padded/billed ledger must match
``repro``'s server exactly, for the staged plan and the megakernel and at
prefetch depths 0, 1 and 2.  The port serves on the CPU here (the plain
versions of the kernels); ``repro`` serves in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chip import interpreter as jinterp, networks as jnets
from repro.serving import ChipServer as JaxChipServer
from repro_torch import convert
from repro_torch.core.chip import networks as tnets
from repro_torch.launch import chip_serve
from repro_torch.serving.server import ChipServer
from tests.test_torch_interpreter import np_params, one_torch_thread  # noqa: F401

_BATCH = 4
_REQUESTS = 11                 # 11 % 4 -> the last dispatch pads


@pytest.fixture(scope="module")
def trace():
    """mnist5's packed artifact, a seeded frame trace, and repro's served
    labels and ledger for it."""
    jprog = jnets.mnist5()
    npp = np_params(jprog, seed=31)
    packed = jinterp.fold_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 jprog, packed=True)
    io = jprog.instrs[0]
    frames = np.random.default_rng(32).integers(
        0, 2 ** io.bits, (_REQUESTS, io.height, io.width, io.in_channels),
        dtype=np.int32)
    server = JaxChipServer({"mnist5": jprog}, {"mnist5": packed},
                           batch=_BATCH, interpret=True)
    server.submit_many("mnist5", frames)
    results = server.drain()
    st = server.stats()
    labels = {r.rid: r.label for r in results}
    return (jax.tree_util.tree_map(np.asarray, packed), frames, labels,
            st.served, st.padded, st.dispatches)


@pytest.mark.parametrize("megakernel", [False, True])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_served_labels_and_ledger_match_repro(trace, megakernel, prefetch):
    np_packed, frames, labels, served, padded, dispatches = trace
    server = ChipServer({"mnist5": tnets.mnist5()},
                        {"mnist5": convert.artifact_from_numpy(
                            np_packed, device="cpu")},
                        batch=_BATCH, megakernel=megakernel,
                        prefetch=prefetch, device="cpu")
    rids = server.submit_many("mnist5", frames)
    results = server.drain()
    server.close()
    assert [r.rid for r in results] == rids            # FIFO, exactly once
    assert {r.rid: r.label for r in results} == labels
    st = server.stats()
    assert st.served == served and st.padded == padded
    assert st.dispatches == dispatches
    assert st.billed == st.total_served + sum(st.padded.values())
    assert st.chip.frames == served


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog = tnets.mnist5()
    art = chip_serve.build_artifact(prog, seed=0, warm_bn=False,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChipServer({"mnist5": prog}, {"mnist5": art})


def test_unported_options_raise():
    """``repro``'s ``donate_frames`` and ``interpret`` have no PyTorch
    counterpart and are refused; the continuous policy (over the static
    or the operating-point policy) and a serving mesh are taken, and a
    batch that does not divide over the mesh is refused as in ``repro``."""
    prog = tnets.mnist5()
    art = chip_serve.build_artifact(prog, seed=0, warm_bn=False,
                                    device="cpu")
    for kw in (dict(donate_frames=True), dict(interpret=True)):
        with pytest.raises(TypeError, match=next(iter(kw))):
            ChipServer({"mnist5": prog}, {"mnist5": art}, device="cpu", **kw)
    for kw, name in ((dict(policy="continuous"), "continuous"),
                     (dict(families={"f": ("mnist5",)},
                           policy="continuous"), "continuous"),
                     (dict(mesh=("cpu", "cpu")), "static")):
        server = ChipServer({"mnist5": prog}, {"mnist5": art}, batch=4,
                            device="cpu", **kw)
        assert server.policy.name == name
    with pytest.raises(ValueError, match="divide"):
        ChipServer({"mnist5": prog}, {"mnist5": art}, batch=3,
                   mesh=("cpu", "cpu"))


def test_chip_serve_driver_on_the_cpu(capsys):
    """The driver end to end: BN-warmed artifacts, two lanes, megakernel,
    prefetch 2; the ledger balances and every request is served."""
    results, stats = chip_serve.main(
        ["--programs", "mnist5,face_detector", "--requests", "10",
         "--batch", "4", "--megakernel", "--prefetch-depth", "2",
         "--device", "cpu"])
    assert len(results) == 10 and stats.total_served == 10
    # 5 frames per lane at batch 4: two dispatches each, 3 slots padded
    assert stats.billed == 16 and stats.padded == {"mnist5": 3,
                                                   "face_detector": 3}
    assert "billing             : 16 billed == 10 served + 6 padded" in (
        capsys.readouterr().out)


def test_abort_hands_back_inflight_requests_in_order(trace):
    """At prefetch 2, after one step dispatch 0 is finished and 1 and 2
    are in flight; abort drops them unmaterialized and returns their
    requests oldest first, while the ledger keeps what was launched."""
    np_packed, frames, *_ = trace
    server = ChipServer({"mnist5": tnets.mnist5()},
                        {"mnist5": convert.artifact_from_numpy(
                            np_packed, device="cpu")},
                        batch=_BATCH, prefetch=2, device="cpu")
    rids = server.submit_many("mnist5", frames)
    first = server.step()
    orphans = server.executor.abort()
    assert [r.rid for r in first] == rids[:_BATCH]
    assert [r.rid for r in orphans] == rids[_BATCH:]
    st = server.stats()
    assert st.dispatches == 3 and st.billed == 12
    assert st.billed == st.total_served + sum(st.padded.values())
