"""The benchmark of ``deephisto_tpu_torch`` (the PyTorch and CUDA port) on
NVIDIA cards. From the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``: set-up (weights from the seed,
the engine, the host pool, a warm-up of every shape the traffic sends),
``--seconds`` of traffic, then the check against the plain reference. The
last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
Exits 2 without a result when the cell's cards are not there, and 3 when
JAX or the JAX package was loaded."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench.core import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    ctx = harness.context(args.workload, args.seed, "cuda:0", bench)
    result, check, found = harness.run_cell(ctx, args.seconds, bool(args.trace), START)
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    print("check: " + json.dumps({k: v for k, v in check.items() if k != "numbers"}),
          file=sys.stderr)
    for name, n in result["check"].items():
        print(f"{name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    found = sorted(set(found) | set(harness.jax_modules()))  # the check ran after run_cell's look
    if found:
        print(f"port_bench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
