"""The readings the limits are set from: the program's numbers over many
seeds and each control's (the reference with one stage one precision step
below the configuration, put in the program's place) on the same
requests, each judged by the same verdict as the program; each seed a
full run of the cell with a short window, all in one process.

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,3 --seconds 5

Prints one JSON line a seed and a summary: for each number, the largest
program reading (the lower reading) and each control's smallest reading
(the upper ones).  Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gpubench import catalog, harness, reference  # noqa: E402
from gpubench.run import ROOT  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    bench = catalog.benchmark(ROOT)
    cfg = catalog.config(catalog.cell(bench, args.workload)["config"])
    controls = reference.controls(cfg["precision"])
    prog, ctrl = {}, {name: {} for name in controls}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run(ROOT, args.workload, seed, args.seconds, False, t0, controls=controls)
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "program": {k: c["value"] for k, c in r["checks"].items()},
                "controls": r["controls"], "metrics": r["metrics"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        for k, v in line["program"].items():
            prog[k] = max(prog.get(k, 0.0), v)
        for name, c in r["controls"].items():
            for k, v in c["numbers"].items():
                ctrl[name][k] = min(ctrl[name].get(k, float("inf")), v)
    for k in prog:
        uppers = ", ".join(f"{name} {ctrl[name].get(k)!r} ({ctrl[name].get(k, 0.0) / prog[k]:.3g}x)"
                           if prog[k] else f"{name} {ctrl[name].get(k)!r}" for name in ctrl)
        print(f"number {k}: lower reading {prog[k]!r}; upper readings {uppers}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
