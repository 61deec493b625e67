"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Needs as many CUDA cards as the cell asks
for: without them it exits with an error and prints no result.  The last
line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`: each number compared with its limit); the last lines of
standard error give the same numbers and limits.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's only build cache, its kernel library, is `build/dafs_tpu_torch/`
# inside the checkout.
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), {n} found", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    line, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   "cuda:0", T_PROCESS)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
