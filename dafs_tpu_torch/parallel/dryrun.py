"""Compile check and multichip dry run of the port.

Port of `__graft_entry__.py`: `entry()` gives the flagship kernel's
forward step with example inputs, and `dryrun_multichip(n)` runs the whole
pipeline of three configurations on a work mesh of n shards and again as
one device, and requires byte-equal output.

    python -m dafs_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import hashlib

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): a batch of ProbCons pair-HMM posterior problems
    (the all-pairs stage), K1, K2 and the posterior kernel on a card."""
    from dafs_tpu_torch.ops import pairhmm

    seqs = ["GGGAAACCCUUCGGGAAACCC", "GGCAAAGGCUUCGGAAAGCC"]
    codes1, len1 = pairhmm.encode_batch(seqs, 32)
    codes2, len2 = pairhmm.encode_batch(seqs[::-1], 32)
    dev = torch.device(device)
    fn = functools.partial(pairhmm.forward_backward_posterior, tab=pairhmm.tables(dev))
    return fn, tuple(torch.from_numpy(a).to(dev) for a in (codes1, len1, codes2, len2))


def synthetic_family():
    """The dry run's family: six 24-nt sequences, 12 % of positions
    redrawn, from `default_rng(0)` (`__graft_entry__.py`)."""
    from dafs_tpu_torch.fasta import Fasta

    rng = np.random.default_rng(0)
    base = "GGGCAACGACGUUCGUCGAAACCC"

    def mut(s: str) -> str:
        return "".join(
            c if rng.random() > 0.12 else str(rng.choice(list("ACGU"))) for c in s
        )

    return [Fasta(f"seq{i}", mut(base)) for i in range(6)]


def mutated_family(seqs, n=50, seed=0):
    """n mutated copies of `seqs` in turn (1 % deletions, 1 % insertions,
    8 % substitutions), from `default_rng(seed)`: the 50-sequence all-pairs
    family of `bench.py`, built from RF00005's ten tRNAs."""
    rng = np.random.default_rng(seed)

    def mutate(s):
        out = []
        for c in s:
            r = rng.random()
            if r < 0.01:
                continue
            if r < 0.02:
                out.append("ACGU"[rng.integers(4)])
            out.append("ACGU"[rng.integers(4)] if rng.random() < 0.08 else c)
        return "".join(out)

    return [mutate(seqs[i % len(seqs)]) for i in range(n)]


CONFIGS = ("default", "ipknot", "contrafold")


def make_engine(config, device):
    """The `pipeline.Dafs` of a dry-run configuration, `t_max=50`, each with
    `Alifold(0.0, bl=True)` (`__graft_entry__.py:77-98`)."""
    from dafs_tpu_torch import pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.ops import alifold
    from dafs_tpu_torch.typedefs import CUTOFF

    opts = pipeline.Options(t_max=50)
    if config == "default":
        a_model = align_models.ProbCons(opts.th_a)
        s_model = fold_models.RNAfold(True, CUTOFF)
    elif config == "ipknot":
        # the --ipknot expansion of the CLI: IPknot decoders inside the DD
        # loop and for the final decode, two threshold levels
        opts.th_s = (0.5, 0.15)
        opts.th_s1 = (0.5, 0.15)
        opts.fold_decoder = "IPknot"
        a_model = align_models.ProbCons(opts.th_a)
        s_model = fold_models.RNAfold(True, CUTOFF)
    elif config == "contrafold":
        a_model = align_models.CONTRAlign(opts.th_a)
        s_model = fold_models.CONTRAfold(CUTOFF)
    else:
        raise ValueError(f"unknown dry-run configuration {config!r}")
    return pipeline.Dafs(a_model, s_model, opts,
                         alifold_model=alifold.Alifold(0.0, bl=True), device=device)


def dryrun_multichip(n_devices: int, device="cuda", configs=CONFIGS) -> list[str]:
    """The full pipeline (fold and all-pairs sharded over the work mesh,
    similarity, PCT with its worklists sharded, guide tree, the DD merges
    with the consensus mix, the final decode) of each configuration on the
    synthetic family, on a mesh of `n_devices` shards: the visible cards
    where there are that many, else shards of the one device given
    (`mesh.virtual_mesh`).  Each runs a second time under
    `force_single_device()`; the outputs must be byte-equal.  Prints one
    line per configuration and returns them."""
    from dafs_tpu_torch.parallel import mesh

    fam = synthetic_family()
    lines = []
    for config in configs:
        with mesh.virtual_mesh(n_devices):
            shards = mesh.work_devices(device)
            out = make_engine(config, device).run(fam)
        with mesh.force_single_device():
            out1 = make_engine(config, device).run(fam)
        if ">SS_cons" not in out or sum(
                line.startswith("> seq") for line in out.splitlines()) != len(fam):
            raise AssertionError(f"[{config}] malformed output:\n{out}")
        h_n = hashlib.sha256(out.encode()).hexdigest()[:16]
        h_1 = hashlib.sha256(out1.encode()).hexdigest()[:16]
        if out != out1:
            raise AssertionError(
                f"[{config}] sharded ({n_devices} shards, sha {h_n}) output differs "
                f"from the single-device run (sha {h_1})")
        cards = sorted({str(d) for d in shards})
        line = (f"dryrun_multichip ok [{config}]: {n_devices} shards on {', '.join(cards)}, "
                f"full pipeline, {len(fam)} seqs, {len(out.splitlines())} output lines; "
                f"sharded sha256[:16]={h_n} == single-device {h_1}")
        print(line, flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
