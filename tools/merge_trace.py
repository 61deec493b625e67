#!/usr/bin/env python3
"""Locate the first progressive merge whose alignment departs from a
recorded output.

    python3 tools/merge_trace.py [--family RF00017_4.fa]
        [--snapshot rf00017_default_tpu.txt] [--device cuda]
        [--out chiprun_out/merge_trace.json]

Progressive alignment never changes the columns within a group once it is
merged: later merges only insert all-gap columns into it.  So the rows of a
recorded final alignment (`tests/snapshots/`), restricted to one merge's
sequences with their all-gap columns dropped, are that merge's alignment in
the recorded run.

Runs DAFS's default path (`Dafs` as `align_and_fold` builds it) twice on the
family from `tests/data/`: with each group of one sequence served from the
fold stage's posteriors (the port's default), and with each served by its
own single-sequence McCaskill run (the route of the JAX package).  For each
merge, in the order solved: its sequences, its DD iterations and violations
at exit (violations > 0 means the 600-iteration cap stopped it), whether its
alignment equals the recorded one, and the largest difference of its
inputs p_x, p_y, p_z between the two runs where both runs gave it the same
children.  Then each run's agreeing `SS_cons` and row columns.  Writes the
report as JSON to `--out` and a summary to standard output.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def read_snapshot(path):
    """(SS_cons, {name: gapped row}) of a recorded output."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[2], dict(zip((l[2:] for l in lines[3::2]), lines[4::2]))


def restrict(rows: list[str]) -> list[str]:
    """The rows with their all-gap columns dropped."""
    keep = [k for k in range(len(rows[0])) if any(r[k] != "-" for r in rows)]
    return ["".join(r[k] for k in keep) for r in rows]


def traced_run(fa, device, own_mccaskill):
    import torch

    from dafs_tpu_torch import dd, pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.ops import alifold
    from dafs_tpu_torch.typedefs import CUTOFF, gapped_seq

    class Alifold(alifold.Alifold):
        """Ignores the fold stage's posteriors when `own_mccaskill` is set."""

        def __setattr__(self, key, value):
            super().__setattr__(key, {} if key == "leaves" and own_mccaskill else value)

    batches = []
    core = dd._dd_core

    def traced_core(pr, **kw):
        out = core(pr, **kw)
        batches.append([v.cpu().numpy().tolist() for v in out[1:3]])
        return out

    class Traced(pipeline.Dafs):
        def _merge_inputs(self, aln1, aln2):
            p = super()._merge_inputs(aln1, aln2)
            ids = sorted(r.seq_id for r in aln1 + aln2)
            children = [{r.seq_id: gapped_seq(self.fa[r.seq_id].seq, r.mask) for r in a}
                        for a in (aln1, aln2)]
            self.merges.append(dict(ids=ids, children=children, inputs=p,
                                    batch=len(batches)))
            return p

        def _merge_finish(self, x, y, z, aln1, aln2):
            ss, aln = pipeline.Dafs._merge_finish(x, y, z, aln1, aln2)
            ids = sorted(r.seq_id for r in aln)
            m = next(m for m in self.merges if m["ids"] == ids)
            m["rows"] = {r.seq_id: gapped_seq(self.fa[r.seq_id].seq, r.mask) for r in aln}
            return ss, aln

    dd._dd_core = traced_core
    try:
        d = Traced(align_models.ProbCons(0.01), fold_models.RNAfold(True, CUTOFF),
                   pipeline.Options(), alifold_model=Alifold(0.0, bl=True), device=device)
        d.merges = []
        d.run(fa)
    finally:
        dd._dd_core = core
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    for m in d.merges:
        t, viol = batches[m["batch"]]
        k = [x["ids"] for x in d.merges if x["batch"] == m["batch"]].index(m["ids"])
        m["dd_iterations"], m["violated"] = t[k], viol[k]
    return d.result, d.merges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="RF00017_4.fa")
    ap.add_argument("--snapshot", default="rf00017_default_tpu.txt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "merge_trace.json"))
    args = ap.parse_args(argv)

    from dafs_tpu_torch.fasta import load_fasta

    fa = load_fasta(os.path.join(ROOT, "tests", "data", args.family))
    names = [f.name for f in fa]
    snap_ss, snap_rows = read_snapshot(os.path.join(ROOT, "tests", "snapshots", args.snapshot))

    runs = {}
    for label, own in (("fold stage", False), ("own McCaskill", True)):
        res, merges = traced_run(fa, args.device, own)
        runs[label] = (res, merges)
    report = dict(family=args.family, snapshot=args.snapshot, device=args.device, runs={})
    other = {tuple(m["ids"]): m for m in runs["own McCaskill"][1]}
    for label, (res, merges) in runs.items():
        out = []
        for m in merges:
            ids = m["ids"]
            got = [m["rows"][i] for i in ids]
            want = restrict([snap_rows[names[i]] for i in ids])
            o = other.get(tuple(ids))
            dp = None
            if o is not None and o["children"] == m["children"]:
                dp = [float(np.abs(a.astype(np.float64) - b).max())
                      for a, b in zip(m["inputs"], o["inputs"])]
            out.append(dict(
                ids=ids, n=len(got[0]),
                dd_iterations=m["dd_iterations"], violated=m["violated"],
                equals_snapshot=got == want,
                columns_agreeing=sum(a == b for g, w in zip(got, want) for a, b in zip(g, w)),
                columns=sum(max(len(g), len(w)) for g, w in zip(got, want)),
                max_abs_input_diff_vs_own_mccaskill=dp, children=m["children"],
            ))
        rows_ok = sum(a == b for n, r in zip(res["names"], res["rows"])
                      for a, b in zip(r, snap_rows[n]))
        report["runs"][label] = dict(
            merges=out,
            ss_cons_agreeing=sum(a == b for a, b in zip(res["ss_cons"], snap_ss)),
            ss_cons_lengths=[len(res["ss_cons"]), len(snap_ss)],
            row_columns_agreeing=rows_ok,
            row_columns=sum(max(len(r), len(snap_rows[n]))
                            for n, r in zip(res["names"], res["rows"])),
            ss_cons=res["ss_cons"], phase_seconds=res["phase_seconds"],
        )
        print(f"{label}: SS_cons {report['runs'][label]['ss_cons_agreeing']} of "
              f"lengths {report['runs'][label]['ss_cons_lengths']} agree with the snapshot; "
              f"rows {rows_ok} of {report['runs'][label]['row_columns']} columns")
        for m in out:
            print(f"  merge {m['ids']} n={m['n']}: DD {m['dd_iterations']} iterations, "
                  f"violated {m['violated']}; equals snapshot {m['equals_snapshot']} "
                  f"({m['columns_agreeing']}/{m['columns']}); input diff vs own "
                  f"McCaskill {m['max_abs_input_diff_vs_own_mccaskill']}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
