"""dafs-compatible command line interface (src/dafs.cpp:1603-1779), port of
`dafs_tpu/cli.py`.

Usage: python -m dafs_tpu_torch.cli [-a ProbCons|CONTRAlign]
       [-s Boltzmann|Vienna|CONTRAfold] [--bp-update] [--bp-update1]
       [--ipknot | --fold-decoder IPknot] [-m T] [-v N] [--no-alifold]
       [-r N] [-f W] [--dd-update subgradient|adagrad|adam]
       [--align-aux F] [--fold-aux F] [--save-align-aux F] [--save-fold-aux F]
       [-P FILE] [--profile DIR] [--device cuda] FILE

The option surface is the JAX CLI's, plus `--device`.  Without options it
runs DAFS's default path.  `--no-alifold` drops the RNAalifold consensus
mix from the progressive merges; the final structure mixes it in all the
same, as in the JAX CLI and the reference (use_alifold1_ is always true).
`--ipknot`, `-m 0` and `-v 2` run the host merge solvers (IPknot's ILPs in
the DD loop, the exact joint ILP, the host DD loop with per-iteration
dumps).  `-r N` refines N times by random bipartition, `-f W` adds the
four-way PCT, `--dd-update` picks the DD's multiplier step, the aux options
read or dump the posteriors in the reference's text format, and `-P` loads
a ViennaRNA parameter file (a process-wide override, as in the JAX CLI).
"""

from __future__ import annotations

import argparse
import os
import sys

VERSION = "0.0.4"  # reference parity: src/CMakeLists.txt:12 (DAFS v0.0.4)


def build_parser() -> argparse.ArgumentParser:
    # option surface + help text mirror src/dafs.cpp:1607-1643
    p = argparse.ArgumentParser(
        prog="dafs-tpu-torch",
        description="DAFS: dual decomposition for simultaneous aligning "
        "and folding RNA sequences (PyTorch / CUDA port).",
    )
    p.add_argument("--version", action="version",
                   version=f"DAFS version {VERSION}")
    p.add_argument("input", metavar="FILE", help="Input file")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("-r", "--refinement", type=int, default=0, metavar="N",
                   help="The number of iteration of the iterative refinment")
    p.add_argument("-w", "--weight", type=float, default=4.0,
                   help="Weight of the expected accuracy score for secondary "
                        "structures")
    p.add_argument("--eta", type=float, default=0.5,
                   help="Initial step width for the subgradient optimization")
    p.add_argument("-m", "--max-iter", type=int, default=600, metavar="T",
                   help="The maximum number of iteration of the subgradient "
                        "optimization")
    p.add_argument("--dd-update", default="subgradient",
                   choices=["subgradient", "adagrad", "adam"],
                   help="multiplier update rule")
    p.add_argument("-f", "--fourway-pct", type=float, default=0.0,
                   help="Weight of four-way PCT")
    p.add_argument("-v", "--verbose", type=int, default=0,
                   help="The level of verbose outputs")
    ga = p.add_argument_group("Aligning")
    ga.add_argument("-a", "--align-model", default="ProbCons",
                    choices=["ProbCons", "CONTRAlign"],
                    help="Alignment model for calculating matching "
                         "probabilities")
    ga.add_argument("-p", "--align-pct", type=float, default=0.25,
                    help="Weight of PCT for matching probabilities")
    ga.add_argument("-u", "--align-th", type=float, default=0.01,
                    help="Threshold for matching probabilities")
    ga.add_argument("--align-aux", metavar="FILENAME",
                    help="Load matching probability matrices from FILENAME")
    gf = p.add_argument_group("Folding")
    gf.add_argument("-s", "--fold-model", default="Boltzmann",
                    choices=["Boltzmann", "Vienna", "CONTRAfold"],
                    help="Folding model for calculating base-pairing "
                         "probabilities")
    gf.add_argument("--fold-decoder", default="Nussinov",
                    choices=["Nussinov", "IPknot"],
                    help="Decoder for common secondary structure prediction")
    gf.add_argument("-q", "--fold-pct", type=float, default=0.25,
                    help="Weight of PCT for base-pairing probabilities")
    gf.add_argument("-t", "--fold-th", type=str, default=None,
                    help="Threshold for base-pairing probabilities")
    gf.add_argument("-g", "--gamma", type=str, default=None,
                    help="Specify the threshold for base-pairing "
                         "probabilities by 1/(gamma+1)")
    gf.add_argument("--no-alifold", action="store_true",
                    help="No use of RNAalifold for calculating base-pairing "
                         "probabilities in the progressive merges (the final "
                         "structure still mixes it in)")
    gf.add_argument("-T", "--fold-th1", type=str, default=None,
                    help="Threshold for base-pairing probabilities of the "
                         "conclusive common secondary structures")
    gf.add_argument("-G", "--gamma1", type=str, default=None,
                    help="Specify the threshold for base-pairing "
                         "probabilities of the conclusive common secondary "
                         "structures by 1/(gamma+1)")
    gf.add_argument("--ipknot", action="store_true",
                    help="Set optimized parameters for IPknot decoding")
    gf.add_argument("--bp-update", action="store_true",
                    help="Use the iterative update of BPs")
    gf.add_argument("--bp-update1", action="store_true",
                    help="Use the iterative update of BPs for the final "
                         "prediction")
    gf.add_argument("--fold-aux", metavar="FILENAME",
                    help="Load base-pairing probability matrices from "
                         "FILENAME")
    p.add_argument("--save-align-aux", metavar="FILENAME",
                   help="dump match posteriors")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the run into DIR "
                        "(a Chrome trace, trace.json; CPU activity, and the "
                        "card's when the device is one) and the program's "
                        "spans of the same run (spans.json; times in seconds "
                        "of time.perf_counter())")
    p.add_argument("--save-fold-aux", metavar="FILENAME",
                   help="dump base-pair posteriors")
    p.add_argument("-P", "--param-file", metavar="FILE", default=None,
                   help="ViennaRNA v2.0 energy parameter file")
    return p


def _parse_floats(s):
    return [float(x) for x in s.split(",")]


def options_from_args(args):
    from dafs_tpu_torch import pipeline

    # threshold resolution (src/dafs.cpp:1709-1750)
    if args.fold_th is not None:
        th_s = _parse_floats(args.fold_th)
    elif args.gamma is not None:
        th_s = [1.0 / (1.0 + g) for g in _parse_floats(args.gamma)]
    elif args.ipknot:
        th_s = [1.0 / (1.0 + 4.0), 1.0 / (1.0 + 8.0)]
    else:
        th_s = [0.2]

    if args.fold_th1 is not None:
        th_s1 = _parse_floats(args.fold_th1)
    elif args.gamma1 is not None:
        th_s1 = [1.0 / (1.0 + g) for g in _parse_floats(args.gamma1)]
    elif args.ipknot:
        th_s1 = [1.0 / (1.0 + 2.0), 1.0 / (1.0 + 4.0)]
    else:
        th_s1 = th_s

    fold_decoder = "IPknot" if (args.ipknot or args.fold_decoder == "IPknot") else "Nussinov"
    return pipeline.Options(
        w=args.weight,
        eta0=args.eta,
        t_max=args.max_iter,
        n_refinement=args.refinement,
        w_pct_a=args.align_pct,
        w_pct_s=args.fold_pct,
        w_pct_f=args.fourway_pct,
        th_a=args.align_th,
        th_s=tuple(th_s),
        th_s1=tuple(th_s1),
        use_alifold=not args.no_alifold,
        use_bp_update=args.bp_update,
        # --bp-update1 XORs with --ipknot (src/dafs.cpp:1767)
        use_bp_update1=bool(args.bp_update1) ^ bool(args.ipknot),
        fold_decoder=fold_decoder,
        verbose=args.verbose,
        save_align_aux=args.save_align_aux,
        save_fold_aux=args.save_fold_aux,
        dd_update=args.dd_update,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.input):
        print(f"{args.input}: No such file or directory", file=sys.stderr)
        return 1

    if args.param_file:
        # before any model is built (dafs_tpu/cli.py:166-169)
        from dafs_tpu_torch.ops.param_file import apply_param_file

        apply_param_file(args.param_file)

    from dafs_tpu_torch.api import make_dafs
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)
    # The final decode always mixes in the consensus regardless of
    # --no-alifold (src/dafs.cpp:81-82,1696), so the model is built
    # unconditionally; --no-alifold only gates the merge steps.
    d = make_dafs(options_from_args(args), device=args.device,
                  align_model=args.align_model, fold_model=args.fold_model,
                  align_aux=args.align_aux, fold_aux=args.fold_aux)
    fa = load_fasta(args.input)
    if args.profile:
        out = _profiled(d, fa, args.profile)
    else:
        out = d.run(fa)
    sys.stdout.write(out)
    return 0


def _profiled(d, fa, out_dir):
    """`d.run(fa)` under torch.profiler and the span recorder
    (`utils/spans.py`); writes `out_dir/trace.json` and `out_dir/spans.json`
    (a list of the spans' records)."""
    import json

    import torch

    from dafs_tpu_torch.utils import spans

    acts = [torch.profiler.ProfilerActivity.CPU]
    if d.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with spans.record() as recs, torch.profiler.profile(activities=acts) as prof:
        out = d.run(fa)
        if d.device.type == "cuda":
            torch.cuda.synchronize(d.device)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "spans.json"), "w") as fh:
        json.dump([sp.as_dict() for sp in recs], fh)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
