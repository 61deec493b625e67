"""High-level Python API.

>>> import dafs_tpu_torch
>>> res = dafs_tpu_torch.align_and_fold(
...     ["GGGCGCAAGCCU", "GGGCGCUUGCCU"], device="cpu")
>>> res.ss_cons
'((((....))))'

The port of `dafs_tpu.align_and_fold`, with every option of one device:
the ProbCons or CONTRAlign alignment model, the BL* or Vienna McCaskill or
the CONTRAfold fold model, the RNAalifold consensus mixed into every merge
and into the final structure, and every `pipeline.Options` field
(bp-update, the host merge solvers, the DD update rules, four-way PCT,
refinement, the aux dumps).  `use_alifold=False` drops the mix from the
merges only, as in the JAX package.  Beyond the JAX package's API it takes
the CLI's aux-file inputs (`align_aux`, `fold_aux`) and parameter file
(`param_file`, which, as `-P` does, sets a process-wide override).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dafs_tpu_torch.fasta import Fasta, load_fasta


@dataclasses.dataclass
class Result:
    """Structured output of one align-and-fold run."""

    tree: str            # guide tree s-expression (reference format)
    ss_cons: str         # common secondary structure, bracket string
    names: list[str]     # sequence names, sorted by input order
    rows: list[str]      # gapped sequences, aligned columns
    score: float         # final joint objective value
    # host wall seconds per pipeline phase, the (N, N) similarity matrix,
    # one record per RNAalifold consensus call (`ops.alifold.Alifold.calls`),
    # (iterations, violations at exit) of each merge in solve order, one list
    # for the host DD loop (`--ipknot`, `-v 2`, `dd_host`) and one for the
    # device DD, and per refinement (`n_refinement`) its two groups of
    # sequence ids, the score before it and the merge's score (`groups`,
    # `s`, `s_new`; the merge is kept when s_new > s)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    similarity: np.ndarray | None = None
    consensus_calls: list = dataclasses.field(default_factory=list)
    host_dd: list = dataclasses.field(default_factory=list)
    device_dd: list = dataclasses.field(default_factory=list)
    refinements: list = dataclasses.field(default_factory=list)

    def __str__(self) -> str:
        lines = [self.tree, ">SS_cons", self.ss_cons]
        for n, r in zip(self.names, self.rows):
            lines += ["> " + n, r]
        return "\n".join(lines) + "\n"


def _records(seqs, names) -> list[Fasta]:
    if isinstance(seqs, str):
        return load_fasta(seqs)
    if seqs and isinstance(seqs[0], Fasta):
        return list(seqs)
    if names is None:
        names = [f"seq{i+1}" for i in range(len(seqs))]
    return [Fasta(n, s) for n, s in zip(names, seqs)]


def make_dafs(opts, *, device, align_model="ProbCons", fold_model="Boltzmann",
              align_aux=None, fold_aux=None):
    """The `pipeline.Dafs` of `opts` and the named models, as the CLI builds
    it (`dafs_tpu/cli.py:207-231`): an aux file replaces its model, and the
    consensus takes the BL* parameters exactly when `fold_model` is
    "Boltzmann"."""
    from dafs_tpu_torch import pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.ops import alifold
    from dafs_tpu_torch.typedefs import CUTOFF

    a_model = (align_models.AUXAlign(align_aux, opts.th_a) if align_aux
               else align_models.by_name(align_model, opts.th_a))
    s_model = (fold_models.AUXFold(fold_aux, CUTOFF) if fold_aux
               else fold_models.by_name(fold_model, CUTOFF))
    return pipeline.Dafs(a_model, s_model, opts,
                         alifold_model=alifold.Alifold(0.0, bl=fold_model == "Boltzmann"),
                         device=device)


def align_and_fold(
    seqs_or_path,
    names=None,
    *,
    device="cuda",
    align_model: str = "ProbCons",
    fold_model: str = "Boltzmann",
    use_alifold: bool = True,
    align_aux: str | None = None,
    fold_aux: str | None = None,
    param_file: str | None = None,
    **options,
) -> Result:
    """Align and fold a set of RNA sequences on `device`.

    Args:
      seqs_or_path: list of RNA strings, list of Fasta records, or a FASTA
        path.
      names: optional names (defaults to seq1..seqN for raw strings).
      device: torch device; "cuda" (the default) raises when no card is
        present.  With several cards visible, "cuda" shards the fold,
        all-pairs and PCT stages over all of them (`parallel.mesh`;
        `CUDA_VISIBLE_DEVICES` selects them); "cuda:k" runs on that card.
      align_model: "ProbCons" or "CONTRAlign".
      fold_model: "Boltzmann", "Vienna" or "CONTRAfold"; the consensus uses
        the BL* parameters under "Boltzmann" and Vienna's otherwise.
      use_alifold: mix the RNAalifold consensus into every merge (the final
        structure always mixes it in).
      align_aux, fold_aux: read the match or base-pair posteriors from a
        file in the reference's aux format (`--align-aux`, `--fold-aux`)
        instead of computing them.
      param_file: a ViennaRNA v2.0 parameter file (`-P`), installed before
        any model is built; the override stays for the rest of the process
        (`ops.energy_params.set_param_overrides({})` removes it).
      **options: overrides for pipeline.Options fields (w, t_max, eta0, th_a,
        th_s, th_s1, w_pct_a, w_pct_s, w_pct_f, n_refinement, dd_update,
        use_bp_update, use_bp_update1, fold_decoder, verbose, dd_host,
        save_align_aux, save_fold_aux, ...).
    """
    from dafs_tpu_torch import pipeline

    if param_file:
        from dafs_tpu_torch.ops.param_file import apply_param_file

        apply_param_file(param_file)
    opts = dataclasses.replace(pipeline.Options(**options), use_alifold=use_alifold)
    d = make_dafs(opts, device=device, align_model=align_model, fold_model=fold_model,
                  align_aux=align_aux, fold_aux=fold_aux)
    d.run(_records(seqs_or_path, names))
    return Result(**d.result)
