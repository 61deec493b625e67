"""Folding models: producers of base-pair probability matrices.

Port of `dafs_tpu/models/fold_models.py` for the McCaskill model (`-s
Boltzmann`, the default, and `-s Vienna`) and the CONTRAfold model (`-s
CONTRAfold`): per-sequence dense upper-triangular BP posterior matrices
thresholded at `th` (strictly greater kept), computed on `device`.
Constrained runs re-fold under a structure constraint string for the
bp-update mechanism (src/dafs.cpp:609-711): '(' ')' a forced pair, '?' free;
'.' is forced unpaired for CONTRAfold, while McCaskill reads it as Vienna
does, as free ('x' is its unpaired mark).  `AUXFold` (`--fold-aux`) reads
the matrices from a file instead, and cannot fold again.
"""

from __future__ import annotations

import numpy as np

from dafs_tpu_torch.fasta import Fasta


class FoldModel:
    def __init__(self, th: float):
        self.th = th

    def batch_bp_posteriors(self, seqs, device, th=None, constraints=None) -> list[np.ndarray]:
        """Posteriors with entries strictly greater than `th` kept (the
        model's threshold by default), one constraint string per sequence
        when `constraints` is given."""
        raise NotImplementedError

    def all_seqs(self, fa: list[Fasta], device, posts=None) -> np.ndarray:
        """(N, L, L) padded tensor of BP posteriors (upper triangle).

        posts: this model's posteriors of `fa` under a lower threshold; they
        are cut to the model's threshold instead of folding again."""
        N = len(fa)
        L = max(len(f) for f in fa)
        bp = np.zeros((N, L, L), dtype=np.float32)
        if posts is None:
            posts = self.batch_bp_posteriors([f.seq for f in fa], device)
        for i, p in enumerate(posts):
            bp[i, : p.shape[0], : p.shape[1]] = np.where(p > self.th, p, np.float32(0.0))
        return bp


class RNAfold(FoldModel):
    """McCaskill partition function with Vienna 2.x semantics; `bl=True`
    applies the Andronescu BL* parameter overrides (default -s Boltzmann,
    src/fold.cpp:70-76)."""

    def __init__(self, bl: bool, th: float):
        super().__init__(th)
        self.bl = bl

    def batch_bp_posteriors(self, seqs, device, th=None, constraints=None):
        from dafs_tpu_torch.ops import mccaskill
        from dafs_tpu_torch.parallel import mesh

        th = self.th if th is None else th
        devices = mesh.work_devices(device)
        if len(devices) > 1:
            return mesh.sharded_bp_posteriors(seqs, th, devices, bl=self.bl,
                                              constraints=constraints)
        return mccaskill.batch_bp_posteriors_fast(seqs, th, device, bl=self.bl,
                                                  constraints=constraints)


class CONTRAfold(FoldModel):
    """CONTRAfold v2 log-linear model (-s CONTRAfold)."""

    def batch_bp_posteriors(self, seqs, device, th=None, constraints=None):
        from dafs_tpu_torch.ops import contrafold

        return contrafold.batch_bp_posteriors(
            seqs, self.th if th is None else th, device, constraints=constraints)


class AUXFold(FoldModel):
    """Precomputed base-pair posteriors from the reference's text format
    (`> x` header, then 1-based `i j:p ...` rows; src/fold.cpp:230-278).
    It holds no model to fold with: a constrained run (bp-update) reaches
    the base class and raises NotImplementedError, as in the JAX package."""

    def __init__(self, path: str, th: float):
        super().__init__(th)
        self.path = path

    def all_seqs(self, fa: list[Fasta], device, posts=None) -> np.ndarray:
        N = len(fa)
        L = max(len(f) for f in fa)
        bp = np.zeros((N, L, L), dtype=np.float32)
        x = None
        with open(self.path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == ">":
                    x = int(parts[1]) - 1
                else:
                    i = int(parts[0]) - 1
                    for tok in parts[1:]:
                        j, p = tok.split(":")
                        bp[x, i, int(j) - 1] = float(p)
        return bp


def by_name(name: str, th: float) -> FoldModel:
    """The model of `-s NAME`: McCaskill with the BL* parameters
    ("Boltzmann") or Vienna's ("Vienna"), or CONTRAfold."""
    if name == "Boltzmann" or name == "Vienna":
        return RNAfold(name == "Boltzmann", th)
    if name == "CONTRAfold":
        return CONTRAfold(th)
    raise ValueError(f"unknown fold model {name!r}; one of Boltzmann, CONTRAfold, Vienna")
