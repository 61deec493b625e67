#!/usr/bin/env python3
"""Locate the first progressive merge whose alignment departs from a
recorded output.

    python3 tools/merge_trace.py [--family RF00017_4.fa]
        [--snapshot rf00017_default_tpu.txt] [--config default|a|c]
        [--device cuda] [--out chiprun_out/merge_trace.json]
    python3 tools/merge_trace.py --config a --device cpu \
        --compare-inputs chiprun_out/merge_trace_inputs.npz

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

`--config a` runs path (a) instead (`-s CONTRAfold -a CONTRAlign`, the
consensus with Vienna's parameters), once: its groups of one sequence run
their own McCaskill anyway.  `--config c` runs path (c), the options the
CLI builds for `--ipknot`, once: every merge goes to the host DD loop with
IPknot's ILPs, and its iterations and violations at exit are the loop's
(`Dafs.host_dd`).  The inputs of the first merge that departs from the
recorded output, with its children's rows and its own, go to
`merge_trace_inputs.npz` beside `--out`.  `--compare-inputs NPZ` takes such
a file (from another device): it runs the same configuration on `--device`
in full, so that every consensus call before that merge is made in the same
order, takes the same merge's inputs there (its children must equal the
recorded ones), prints the largest difference of p_x, p_y and p_z, and
solves both sets of inputs with the exact joint ILP (`dd.solve_by_ip`) and,
under `--config c`, with the host DD loop of the run, printing for each
whether its alignment equals the recorded one or the file's.
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


# the runs of each configuration: (label, whether groups of one sequence
# run their own McCaskill); --compare-inputs uses the last
VARIANTS = {
    "default": (("fold stage", False), ("own McCaskill", True)),
    "a": (("path (a)", True),),
    "c": (("path (c)", False),),
}


def models(config):
    """(align model, fold model, consensus bl, options) of a configuration."""
    from dafs_tpu_torch import cli, pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.typedefs import CUTOFF

    if config == "a":
        return (align_models.CONTRAlign(0.01), fold_models.CONTRAfold(CUTOFF), False,
                pipeline.Options())
    opts = (cli.options_from_args(cli.build_parser().parse_args(["--ipknot", "x.fa"]))
            if config == "c" else pipeline.Options())
    return align_models.ProbCons(0.01), fold_models.RNAfold(True, CUTOFF), True, opts


def traced_run(fa, device, own_mccaskill, config="default"):
    import torch

    from dafs_tpu_torch import dd, pipeline
    from dafs_tpu_torch.ops import alifold
    from dafs_tpu_torch.typedefs import gapped_seq

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
        a_model, s_model, bl, opts = models(config)
        d = Traced(a_model, s_model, opts, alifold_model=Alifold(0.0, bl=bl), device=device)
        d.merges = []
        d.run(fa)
    finally:
        dd._dd_core = core
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    if d.host_dd:  # one merge at a time, each by the host DD loop
        for m, (t, viol) in zip(d.merges, d.host_dd, strict=True):
            m["dd_iterations"], m["violated"] = t, viol
        return d.result, d.merges
    for m in d.merges:
        t, viol = batches[m["batch"]]
        k = [x["ids"] for x in d.merges if x["batch"] == m["batch"]].index(m["ids"])
        m["dd_iterations"], m["violated"] = t[k], viol[k]
    return d.result, d.merges


def compare_inputs(fa, args, snap_rows):
    """The other side of --compare-inputs (see the module docstring)."""
    import time

    from dafs_tpu_torch import dd, pipeline
    from dafs_tpu_torch.typedefs import AlnRow, gapped_seq

    rec = np.load(args.compare_inputs, allow_pickle=False)
    children = json.loads(str(rec["children"]))
    ids = [int(i) for i in rec["ids"]]
    theirs_rows = [str(r) for r in rec["rows"]]

    t0 = time.perf_counter()
    _, merges = traced_run(fa, args.device, VARIANTS[args.config][-1][1], args.config)
    m = next(m for m in merges if m["ids"] == ids)
    if [{str(k): v for k, v in c.items()} for c in m["children"]] != children:
        raise SystemExit(f"merge {ids}: its children on {args.device} differ from the file's")
    mine = m["inputs"]
    theirs = [rec["p_x"], rec["p_y"], rec["p_z"]]
    diffs = [float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(mine, theirs)]
    scale = [float(np.abs(b).max()) for b in theirs]
    print(f"merge {ids}: a full run on {args.device} in {time.perf_counter() - t0:.1f}s, its DD "
          f"{m['dd_iterations']} iterations, violated {m['violated']} at exit; max |p_x|, |p_y|, "
          f"|p_z| differences {diffs} (largest values {scale}; one float32 rounding there is "
          f"{[v * 2 ** -24 for v in scale]})")
    names = [f.name for f in fa]
    want = restrict([snap_rows[names[i]] for i in ids])
    alns = [[AlnRow(int(k), np.array([c != "-" for c in row], bool)) for k, row in ch.items()]
            for ch in children]
    o = models(args.config)[3]
    solvers = {"solve_by_ip": dd.solve_by_ip}
    if args.config == "c":
        solvers["host DD"] = lambda *a, **k: dd.solve_by_dd_ipknot(
            *a, **k, device=args.device, structure_decoder="ipknot",
            trace_cb=lambda *t: trace.append(t))
    out = dict(ids=ids, input_diffs=diffs, dd_iterations=m["dd_iterations"],
               violated=m["violated"], solutions={})
    for label, (p_x, p_y, p_z) in ((args.device, mine), ("file", theirs)):
        for solver, solve in solvers.items():
            trace = []
            t1 = time.perf_counter()
            s, x, y, z = solve(p_x, p_y, p_z, len(alns[0]), len(alns[1]), w=o.w,
                               th_s=list(o.th_s), th_a=o.th_a, eta0=o.eta0, t_max=o.t_max)
            _, aln = pipeline.Dafs._merge_finish(x, y, z, *alns)
            got = {r.seq_id: gapped_seq(fa[r.seq_id].seq, r.mask) for r in aln}
            got = [got[i] for i in ids]
            key = f"{solver} on the {label} inputs"
            out["solutions"][key] = dict(
                score=s, equals_snapshot=got == want, equals_file=got == theirs_rows,
                iterations=len(trace) or None, violated=trace[-1][2] if trace else None,
                rows=got, seconds=time.perf_counter() - t1)
            print(f"  {key}: {time.perf_counter() - t1:.1f}s, score {s!r}"
                  + (f", {len(trace)} iterations, violated {trace[-1][2]} at exit"
                     if trace else "")
                  + f"; alignment equals the recorded one: {got == want}, the file's: "
                  f"{got == theirs_rows}")
    for solver in solvers:
        a, b = (out["solutions"][f"{solver} on the {k} inputs"]["rows"] for k in (args.device, "file"))
        print(f"  {solver}: the two sets of inputs give {'one' if a == b else 'two'} alignment(s)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="RF00017_4.fa")
    ap.add_argument("--snapshot", default=None,
                    help="default: rf00017_default_tpu.txt, or "
                         "rf00017_contrafold_contralign_cpu.txt under --config a")
    ap.add_argument("--config", default="default", choices=sorted(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare-inputs", default=None, metavar="NPZ")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "merge_trace.json"))
    args = ap.parse_args(argv)
    if args.snapshot is None:
        args.snapshot = ("rf00017_contrafold_contralign_cpu.txt" if args.config == "a"
                         else "rf00017_default_tpu.txt")

    from dafs_tpu_torch.fasta import load_fasta

    fa = load_fasta(os.path.join(ROOT, "tests", "data", args.family))
    names = [f.name for f in fa]
    snap_ss, snap_rows = read_snapshot(os.path.join(ROOT, "tests", "snapshots", args.snapshot))
    if args.compare_inputs:
        out = compare_inputs(fa, args, snap_rows)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        return 0

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    runs = {}
    variants = VARIANTS[args.config]
    for label, own in variants:
        res, merges = traced_run(fa, args.device, own, args.config)
        runs[label] = (res, merges)
    report = dict(family=args.family, snapshot=args.snapshot, config=args.config,
                  device=args.device, runs={})
    other = {tuple(m["ids"]): m for m in runs[variants[-1][0]][1]}
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
        first = next((m for m in merges
                      if [m["rows"][i] for i in m["ids"]]
                      != restrict([snap_rows[names[i]] for i in m["ids"]])), None)
        if first is not None and label == variants[-1][0]:
            np.savez(os.path.join(os.path.dirname(args.out), "merge_trace_inputs.npz"),
                     p_x=first["inputs"][0], p_y=first["inputs"][1], p_z=first["inputs"][2],
                     ids=np.array(first["ids"]),
                     rows=np.array([first["rows"][i] for i in first["ids"]]),
                     children=json.dumps([{str(k): v for k, v in c.items()}
                                          for c in first["children"]]))
            print(f"{label}: first merge departing from the snapshot {first['ids']}: DD "
                  f"{first['dd_iterations']} iterations, violated {first['violated']} at exit")
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
