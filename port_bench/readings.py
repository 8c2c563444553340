"""Readings of a cell's check over many seeds in one process, with its
control: for each seed a run of ``--seconds`` at the cell's own traffic,
then the program's number and the control's on the same sample (the
control: the reference in the precision below the configuration's, put
in the program's place). From the checkout's root:

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 8

Prints one JSON line a seed, with the control judged by the cell's
limits as ``control_correct``, and last, on standard error, on how many
seeds the program and the control came out correct. Sets no limit
(``checks/<cell>.json`` holds it, set from these readings)."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()

    import torch

    from port_bench.core.harness import context, run_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    tally = {"program": 0, "control": 0, "seeds": 0}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = context(args.workload, seed, "cuda:0")
        result, check, found = run_cell(ctx, args.seconds, False, t0, control=True)
        row = {"workload": args.workload, "seed": seed,
               "numbers": result["check"], "program": check.get("readings"),
               "control": check.get("control"),
               "correct": result["correct"], "control_correct": check.get("control_correct"), "attempted": result["attempted"],
               "failed": result["failed"], "checked": check.get("requests_checked"),
               "cells": check.get("cells"), "metrics": result["metrics"],
               "seconds_total": time.perf_counter() - t0, "jax": found}
        print(json.dumps(row), flush=True)
        tally["seeds"] += 1
        tally["program"] += bool(result["correct"])
        tally["control"] += bool(check.get("control_correct"))
    print(f"{args.workload}: correct on {tally['program']} of {tally['seeds']} seeds, "
          f"the control on {tally['control']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
