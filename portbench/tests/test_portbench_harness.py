"""The harness is driven by data: every name and unit of BENCHMARK.json
is well formed, each cell's files are found by name, a cell made of new
data files alone runs, and no run loads JAX or its package; the reference
loads nothing of the program."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_the_allowed_characters():
    bench = _bench()
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    names += [c["name"] for c in bench["configs"]]
    names += [w[k] for w in bench["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    assert all(UNIT.fullmatch(m["unit"]) for m in metrics)
    for key in ("configs", "workloads"):
        assert len({c["name"] for c in bench[key]}) == len(bench[key])
    assert len(set(n for n in (m["name"] for m in metrics))) == len(metrics)


def test_every_cells_files_are_found_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        files = harness.resolve(bench, cell["name"])
        assert files["entry"].is_file(), files["entry"]
        assert files["metrics"]
        for path in files["metrics"].values():
            assert path.is_file(), path
        assert (ROOT / next(c["file"] for c in bench["configs"]
                            if c["name"] == cell["config"])).is_file()


def test_a_cell_of_new_data_files_runs_without_a_code_edit(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((root / "traffic" / "bulk.json").read_text())
    traffic.update(batch=3, pool_batches=2)
    (root / "traffic" / "bulk_small.json").write_text(json.dumps(traffic))
    bench = _bench()
    bench["workloads"].append(dict(
        name="cifar9_s1.bulk_small", config="cifar9_s1",
        traffic="bulk_small", chips=1, why="a test"))
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["cifar9_s1.bulk_small"]
    files = harness.resolve(bench, "cifar9_s1.bulk_small", root)
    assert files["traffic"]["batch"] == 3
    result = harness.run_cell("cifar9_s1.bulk_small", 2 ** 31 + 5, 60.0,
                              False, t_start=time.perf_counter(),
                              bench=bench, root=root, device="cpu",
                              max_dispatches=1, log=lambda *a: None)
    assert result["correct"] and result["attempted"] == 3
    assert set(result["metrics"]) == {"frames_per_s", "label_p95_ms",
                                      "setup_s"}
    assert list(result)[-1] == "checks"


def _modules_after(code):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\nprint(json.dumps(sorted(sys.modules)))")],
        env=env, capture_output=True, text=True, timeout=600, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_no_run_loads_jax_or_its_package():
    code = (
        "import time\n"
        "from portbench import harness, counts, gen, trace\n"
        "for kind, names in (('entries', ('solo', 'cascade', 'delta')),\n"
        "                    ('metrics', [p.stem for p in\n"
        "                     (harness.HERE / 'metrics').glob('*.py')])):\n"
        "    for n in names:\n"
        "        harness.load_module(kind, n)\n"
        "harness.run_cell('cifar9_s1.bulk', 3, 60.0, False,\n"
        "    t_start=time.perf_counter(), device='cpu',\n"
        "    overrides=dict(batch=1, pool_batches=1), max_dispatches=1,\n"
        "    log=lambda *a: None)")
    top = _modules_after(code)
    assert "repro_torch" in top
    assert top.isdisjoint(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after("import portbench.reference.net, "
                         "portbench.reference.rules")
    assert "torch" in top
    assert top.isdisjoint({"repro_torch", *harness.FORBIDDEN})


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cifar9_s1.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cifar9_s1.bulk",
         "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(os.environ, TMPDIR=str(tmp_path)),
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


class _Ev:
    def __init__(self, name, device, a, b):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = type("R", (), {"start": a, "end": b})()


def test_trace_reduction_counts_busy_time_and_charges_gaps_to_spans():
    from portbench import trace
    events = [_Ev("window", False, 0, 100), _Ev("window", True, 0, 100),
              _Ev("plan.call", False, 0, 10), _Ev("plan.call", True, 0, 10),
              _Ev("labels.fetch", False, 50, 90),
              _Ev("kernel_a", True, 5, 40), _Ev("kernel_b", True, 30, 60),
              _Ev("memcpy", True, 95, 120)]
    out = trace.reduce_profile(type("P", (), {"events": lambda s: events})())
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(60e-6)      # 5-60 and 95-100
    assert dict(out["device_ops"]) == pytest.approx(
        {"kernel_a": 35e-6, "kernel_b": 30e-6, "memcpy": 5e-6})
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"plan.call": 5e-6, "labels.fetch": 35e-6})
