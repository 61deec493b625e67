"""The readings that a cell's limits are set from, on a card.

    python portbench/control.py --workload NAME --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed: the program runs the seed's warm family (the mix's largest
size) and the first `families - 1` families of its stream, as a window
runs them; the check's numbers of those families are the program's
readings (the lower ones).  For each control seed, the reference computed
with TF32 on is put in the program's place at the same families and merges
and judged the same way (`check.control_numbers`): the upper readings.
One JSON line per seed and kind on standard output; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seeds, control_seeds, device, out=sys.stdout):
    import numpy as np
    import torch

    from portbench import check, harness, traffic
    from portbench.reference.family import Reference

    config = cell.config
    spec = cell.checks
    ref = Reference(config["options"], config["fold_model"], config["align_model"], device,
                    root=cell.root)
    ctrl = Reference(config["options"], config["fold_model"], config["align_model"], device,
                     tf32=True, root=cell.root)
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        fams = traffic.Families(cell.mix, seed, cell.root)
        todo = [fams.warm()] + [fams.next() for _ in range(spec["families"] - 1)]
        rng = np.random.default_rng([int(seed) % 2**64, 3])
        caps = []
        capture = harness.Capture()
        try:
            for records in todo:
                t0 = time.perf_counter()
                d, _ = harness._family_run(config, records, device)
                harness._sync(device)
                layers, _, final, updates = capture.take()
                res = d.result
                caps.append(dict(records=records, bp=d.bp, mp=d.mp, sim=res["similarity"],
                                 tree=d.tree, rows=res["rows"], ss_cons=res["ss_cons"],
                                 layers=layers, final_p=final[0], updates=updates,
                                 wall=time.perf_counter() - t0))
                del d, res
        finally:
            capture.close()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        for cap in caps:
            check.plan(cap, spec, rng)
        for kind, wanted in (("program", seed in seeds), ("control", seed in control_seeds)):
            if not wanted:
                continue
            nums: dict = {}
            t0 = time.perf_counter()
            for cap in caps:
                got = (check.check_family(ref, cap) if kind == "program"
                       else check.control_numbers(ref, ctrl, cap))
                for k, v in got.items():
                    nums[k] = max(nums.get(k, -math.inf), v)
            row = dict(workload=cell.name, seed=seed, kind=kind, numbers=nums,
                       families=[len(c["records"]) for c in caps],
                       walls=[c["wall"] for c in caps], check_s=time.perf_counter() - t0)
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(ROOT, "BENCHMARK.json"), args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    readings(cell, ints(args.seeds), ints(args.control_seeds), "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
