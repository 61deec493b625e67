"""High-level Python API.

>>> import dafs_tpu_torch
>>> res = dafs_tpu_torch.align_and_fold(
...     ["GGGCGCAAGCCU", "GGGCGCUUGCCU"], device="cpu")
>>> res.ss_cons
'((((....))))'

The port of `dafs_tpu.align_and_fold` for the slice that is ported so far:
the default ProbCons + BL* McCaskill path, run without the RNAalifold
consensus mix (`use_alifold=False`, which also drops the mix from the final
structure; see `pipeline.Dafs`).  Keyword arguments override
`pipeline.Options` fields; any option outside the slice raises
`NotImplementedError` naming the ROADMAP item that brings it.
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
    # host wall seconds per pipeline phase, and the (N, N) similarity matrix
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    similarity: np.ndarray | None = None

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


def align_and_fold(
    seqs_or_path,
    names=None,
    *,
    device="cuda",
    align_model: str = "ProbCons",
    fold_model: str = "Boltzmann",
    use_alifold: bool = False,
    **options,
) -> Result:
    """Align and fold a set of RNA sequences on `device`.

    Args:
      seqs_or_path: list of RNA strings, list of Fasta records, or a FASTA
        path.
      names: optional names (defaults to seq1..seqN for raw strings).
      device: torch device; "cuda" (the default) raises when no card is
        present.
      **options: overrides for pipeline.Options fields (w, t_max, eta0, th_a,
        th_s, th_s1, w_pct_a, w_pct_s, ...).
    """
    from dafs_tpu_torch import pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.typedefs import CUTOFF

    if use_alifold:
        raise NotImplementedError(pipeline.NOT_PORTED["use_alifold"])
    if align_model != "ProbCons":
        raise NotImplementedError(pipeline.NOT_PORTED["align_model"])
    if fold_model != "Boltzmann":
        raise NotImplementedError(pipeline.NOT_PORTED["fold_model"])
    opts = pipeline.Options(**options)
    d = pipeline.Dafs(
        align_models.ProbCons(opts.th_a),
        fold_models.RNAfold(True, CUTOFF),
        opts,
        device=device,
    )
    d.run(_records(seqs_or_path, names))
    return Result(**d.result)
