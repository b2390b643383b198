"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object on the
last line of standard output, and each number the check compared, beside
its limit, as the last lines of standard error.  Exits non-zero, with no
result, where there is no CUDA card or fewer than the cell asks for,
where the program is missing, or where a module of JAX or its package got
loaded.  Every build and cache stays inside the checkout or the run's
temporary directory; the autotune cache is pinned to an absent file, so
every launch takes the program's own geometry formula.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _pin_caches() -> None:
    absent = Path(tempfile.gettempdir()) / "portbench" / "autotune-absent.json"
    if absent.exists():
        raise SystemExit(f"{absent} exists; the autotune cache must be cold")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(absent)
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" /
                                             "torch_extensions")


def prepare() -> None:
    """Pin the caches and put the program and the benchmark on the path;
    raise SystemExit where the program is not in the checkout."""
    _pin_caches()
    for path in (CHECKOUT / "src", CHECKOUT):
        sys.path.insert(0, str(path))
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        raise SystemExit("the program (src/repro_torch) is not in this "
                         "checkout")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    import torch
    from portbench import harness
    print(f"setup: torch imported at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    bench = harness.load_bench()
    cell = next((c for c in bench["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, bench=bench,
        log=lambda *a: print(*a, file=sys.stderr))
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or its package loaded: {bad}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
