#!/usr/bin/env python3
"""The consensus kernels (`csrc/alifold.cu`) of two checkouts, timed on one
card at the same inputs, in turns.

    python3 tools/torch_consensus_ab.py --other DIR [--order o,t,t,o] [--reps 5]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that `.gitignore` lists).  Each
turn (`t` this checkout, `o` the other) runs in a fresh interpreter with
that checkout's package, builds its kernel library into that checkout's
`build/`, and at each alignment below takes the pf-scale ladder from its
first scale with the kernels, then times inside, exterior and outside
(CUDA events, one warm-up, `--reps` runs) and one whole call, and counts
the launches of a call.  The alignments, from this checkout's
`tests/snapshots` and `tests/data`: RF00005's TPU output (NS 10, n 85),
RF00017's (NS 10, n 385) and bench.py's fifty mutated RF00005 tRNAs
aligned by cutting each to 69 columns (NS 50, n 69).  Prints one JSON
line a turn, then a summary of the mean ms of each side and their ratio,
and the card's name and power limit.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r'''
import json, sys
import numpy as np
import torch
from dafs_tpu_torch.ops import alifold, alifold_cuda
from dafs_tpu_torch.ops import alifold_kernel as ak

shapes, reps = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
kernels = (alifold_cuda.INSIDE, alifold_cuda.EXTERIOR, alifold_cuda.OUTSIDE)


def ms(fn):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


out = {}
for label, seqs in shapes.items():
    x = alifold._inputs(seqs, True, None)
    n = x["n"]
    BCUT = alifold._bcut(x["S"], n)
    args = alifold.device_args(x, dev)
    _, Q, sc, attempts = alifold.partition(args, n, x["bsn0"], alifold.SC0, BCUT,
                                           alifold_cuda.inside_outside)
    p = ak.prepare(*args, n, sc, x["bsn0"])
    pk = alifold_cuda.pack(p, n, BCUT)
    la = alifold_cuda.launch_args(pk)
    before = [k.launches for k in kernels]
    alifold_cuda.inside(pk, la)
    alifold_cuda.exterior(pk, la)
    alifold_cuda.outside(pk, la)
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(kernels, before)]
    row = {"ns": len(seqs), "n": n, "bcut": BCUT, "Q": Q, "attempts": attempts,
           "launches": launches}
    for name, fn in (("inside", lambda: alifold_cuda.inside(pk, la)),
                     ("exterior", lambda: alifold_cuda.exterior(pk, la)),
                     ("outside", lambda: alifold_cuda.outside(pk, la)),
                     ("call", lambda: alifold_cuda.inside_outside(p, n, BCUT=BCUT))):
        row[name + "_ms"] = ms(fn)
    out[label] = row
print("TURN " + json.dumps(out), flush=True)
'''


def snapshot_rows(name):
    with open(os.path.join(ROOT, "tests", "snapshots", name)) as fh:
        return fh.read().splitlines()[4::2]


def shapes():
    sys.path.insert(0, ROOT)
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.parallel import dryrun

    fam = dryrun.mutated_family([f.seq for f in load_fasta(
        os.path.join(ROOT, "tests", "data", "RF00005_0.fa"))])
    cut = min(len(s) for s in fam)
    return {"RF00005 final (10, 85)": snapshot_rows("rf00005_default_tpu.txt"),
            "RF00017 final (10, 385)": snapshot_rows("rf00017_default_tpu.txt"),
            f"family-50 cut (50, {cut})": [s[:cut] for s in fam]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--order", default="o,t,t,o")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    trees = {"t": ROOT, "o": os.path.abspath(a.other)}
    arg = json.dumps(shapes())
    runs = {"t": [], "o": []}
    for side in a.order.split(","):
        env = dict(os.environ, PYTHONPATH=trees[side])
        res = subprocess.run([sys.executable, "-c", TURN, arg, str(a.reps)], cwd=trees[side],
                             env=env, capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            raise SystemExit(f"turn {side} ({trees[side]}) failed")
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("TURN ")][-1]
        runs[side].append(json.loads(line[5:]))
        print(f"turn {side}: {line[5:]}", flush=True)
    for label in runs["t"][0]:
        for key in ("inside_ms", "exterior_ms", "outside_ms", "call_ms"):
            mt = statistics.mean(r[label][key] for r in runs["t"])
            mo = statistics.mean(r[label][key] for r in runs["o"])
            print(f"{label} {key}: other {mo:.4f} this {mt:.4f} (this / other {mt / mo:.3f}); "
                  f"launches other {runs['o'][0][label]['launches']} this "
                  f"{runs['t'][0][label]['launches']}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
