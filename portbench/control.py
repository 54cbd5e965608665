"""Readings that set the limits of the check that decides `correct`.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--sound] [--control] [--faults [name,name]]

On the card, at the cell's own size and load, in one process: for each
seed a short window of the cell as `run.py` drives it, then the same
comparison with the reference. `--sound`: the program as configured (the
lower readings); `--control`: the program with its own lower-precision
path switched on, W8A8 int8 encoders (`encoder_quant="int8"`) under a
configuration that states bfloat16 (the upper readings); `--faults`: each
fault of `portbench/harness/faults.py` planted in the timed path, or those
named. The benchmark's own runs never run this. Prints one line per run
with the check's numbers, and last a JSON object with the largest sound and the smallest
control and fault reading of each number.
"""
import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.harness.check import NUMBERS  # noqa: E402
from portbench.harness.faults import FAULTS  # noqa: E402


def readings(workload, seeds, seconds, kinds, device=None, root=ROOT,
             bench=BENCH):
    """{kind: [numbers of each seed]} for the kinds asked: "sound",
    "control" and the fault names."""
    out = {}
    for kind in kinds:
        for seed in seeds:
            argv = ["--workload", workload, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", "0"]
            if kind == "control":
                res = run.main(argv, root, bench, device,
                               overrides={"encoder_quant": "int8"})
            elif kind == "sound":
                res = run.main(argv, root, bench, device)
            else:
                with FAULTS[kind]():
                    res = run.main(argv, root, bench, device)
            nums = {n: res["check"][n]["value"] for n in NUMBERS}
            out.setdefault(kind, []).append(nums)
            print(f"reading {workload} {kind} seed {seed}: correct "
                  f"{res['correct']} " + ", ".join(
                      f"{n} {v:.6g}" for n, v in nums.items()), flush=True)
    return out


def summary(out):
    res = {}
    for kind, runs in out.items():
        pick = max if kind == "sound" else min
        res[kind] = {n: pick(r[n] for r in runs) for n in NUMBERS}
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sound", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="?", const="all", default=None)
    a = p.parse_args(argv)
    faults = (list(FAULTS) if a.faults == "all"
              else a.faults.split(",") if a.faults else [])
    kinds = (["sound"] if a.sound else []) + (
        ["control"] if a.control else []) + faults
    seeds = [int(s) for s in a.seeds.split(",")]
    out = readings(a.workload, seeds, a.seconds, kinds)
    print(json.dumps({"workload": a.workload, "seeds": seeds,
                      "summary": summary(out), "runs": out}), flush=True)


if __name__ == "__main__":
    main()
