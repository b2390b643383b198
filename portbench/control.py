"""The check's two readings, on the card at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n,n,...> \
        --seconds <s>

For each seed, in one process, two runs of the cell as the benchmark runs
it (``harness.run_cell``): the program's, whose sampled dispatches are
compared with the plain reference (the sound readings), and the control's,
in which the reference computed at the next precision below the
configuration's, 6 of the 7 input bits, takes the program's place in the
same comparison.  Prints one JSON line a run, then the largest sound
reading and the smallest control reading of each number over the seeds.
Exits non-zero where a sound run is not correct or a control run is.
"""

import argparse
import json
import sys
import time

import run as _run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    _run.prepare()
    from portbench import harness
    readings = {False: {}, True: {}}
    held = True
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in (False, True):
            result = harness.run_cell(
                args.workload, seed, args.seconds, False,
                t_start=time.perf_counter(), control=control,
                log=lambda *a: print(*a, file=sys.stderr))
            checks = {k: v["value"] for k, v in result["checks"].items()}
            print(json.dumps({"seed": seed, "control": control,
                              "correct": result["correct"],
                              "checks": checks}), flush=True)
            held &= result["correct"] != control
            pick = min if control else max
            seen = readings[control]
            for key, value in checks.items():
                seen[key] = pick(seen.get(key, value), value)
    print(json.dumps({"lower (largest sound reading)": readings[False],
                      "upper (smallest control reading)": readings[True],
                      "sound runs correct, control runs not": held}))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
