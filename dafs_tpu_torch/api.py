"""High-level Python API.

>>> import dafs_tpu_torch
>>> res = dafs_tpu_torch.align_and_fold(
...     ["GGGCGCAAGCCU", "GGGCGCUUGCCU"], device="cpu")
>>> res.ss_cons
'((((....))))'

The port of `dafs_tpu.align_and_fold` for the slice that is ported so far:
the ProbCons or CONTRAlign alignment model, the BL* or Vienna McCaskill or
the CONTRAfold fold model, bp-update, the RNAalifold consensus mixed
into every merge and into the final structure, and the host merge solvers
(`fold_decoder="IPknot"`, `t_max=0`, `verbose=2`, `dd_host=True`).
`use_alifold=False` drops the mix from the merges only, as in the JAX
package.  Keyword arguments override `pipeline.Options` fields; the options
still outside the slice (`n_refinement`, `w_pct_f`, the aux files,
`dd_update` other than "subgradient") raise `NotImplementedError` naming
the ROADMAP item that brings them.
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
    # and (iterations, violations at exit) of each merge that the host DD
    # loop solved (`--ipknot`, `-v 2`, `dd_host`), in solve order
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    similarity: np.ndarray | None = None
    consensus_calls: list = dataclasses.field(default_factory=list)
    host_dd: list = dataclasses.field(default_factory=list)

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
    use_alifold: bool = True,
    **options,
) -> Result:
    """Align and fold a set of RNA sequences on `device`.

    Args:
      seqs_or_path: list of RNA strings, list of Fasta records, or a FASTA
        path.
      names: optional names (defaults to seq1..seqN for raw strings).
      device: torch device; "cuda" (the default) raises when no card is
        present.
      align_model: "ProbCons" or "CONTRAlign".
      fold_model: "Boltzmann", "Vienna" or "CONTRAfold"; the consensus uses
        the BL* parameters under "Boltzmann" and Vienna's otherwise.
      use_alifold: mix the RNAalifold consensus into every merge (the final
        structure always mixes it in).
      **options: overrides for pipeline.Options fields (w, t_max, eta0, th_a,
        th_s, th_s1, w_pct_a, w_pct_s, use_bp_update, use_bp_update1,
        fold_decoder, verbose, dd_host, ...).
    """
    from dafs_tpu_torch import pipeline
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.ops import alifold
    from dafs_tpu_torch.typedefs import CUTOFF

    opts = dataclasses.replace(pipeline.Options(**options), use_alifold=use_alifold)
    d = pipeline.Dafs(
        align_models.by_name(align_model, opts.th_a),
        fold_models.by_name(fold_model, CUTOFF),
        opts,
        alifold_model=alifold.Alifold(0.0, bl=fold_model == "Boltzmann"),
        device=device,
    )
    d.run(_records(seqs_or_path, names))
    return Result(**d.result)
