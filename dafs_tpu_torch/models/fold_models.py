"""Folding models: producers of base-pair probability matrices.

Port of `dafs_tpu/models/fold_models.py` for the McCaskill model (`-s
Boltzmann`, the default, and `-s Vienna`, which without a parameter file
uses the same tables): per-sequence dense upper-triangular BP posterior
matrices thresholded at `th` (strictly greater kept), computed on `device`.
"""

from __future__ import annotations

import numpy as np

from dafs_tpu_torch.fasta import Fasta


class FoldModel:
    def __init__(self, th: float):
        self.th = th

    def batch_bp_posteriors(self, seqs, device) -> list[np.ndarray]:
        raise NotImplementedError

    def all_seqs(self, fa: list[Fasta], device) -> np.ndarray:
        """(N, L, L) padded tensor of BP posteriors (upper triangle)."""
        N = len(fa)
        L = max(len(f) for f in fa)
        bp = np.zeros((N, L, L), dtype=np.float32)
        posts = self.batch_bp_posteriors([f.seq for f in fa], device)
        for i, p in enumerate(posts):
            bp[i, : p.shape[0], : p.shape[1]] = p
        return bp


class RNAfold(FoldModel):
    """McCaskill partition function with Vienna 2.x semantics; `bl=True`
    applies the Andronescu BL* parameter overrides (default -s Boltzmann,
    src/fold.cpp:70-76)."""

    def __init__(self, bl: bool, th: float):
        super().__init__(th)
        self.bl = bl

    def batch_bp_posteriors(self, seqs, device):
        from dafs_tpu_torch.ops import mccaskill

        return mccaskill.batch_bp_posteriors_fast(seqs, self.th, device, bl=self.bl)
