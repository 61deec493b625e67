"""Alignment models: producers of match-probability matrices.

Port of `dafs_tpu/models/align_models.py` for the ProbCons model (the
default `-a ProbCons`): for every unordered sequence pair, a dense match
posterior matrix thresholded at `th` (entries kept strictly greater), all
N*(N-1)/2 pairs batched into one padded run on `device`.
"""

from __future__ import annotations

import numpy as np

from dafs_tpu_torch.fasta import Fasta


class AlignModel:
    def __init__(self, th: float):
        self.th = th

    def batch_pair_posteriors(self, seqs1, seqs2, device) -> list[np.ndarray]:
        raise NotImplementedError

    def all_pairs(self, fa: list[Fasta], device) -> np.ndarray:
        """(N, N, L, L) tensor: mp[x,y] dense posteriors, mp[y,x] transpose,
        mp[x,x] identity (src/align.cpp:35-52 + transpose at src/dafs.cpp:1797)."""
        N = len(fa)
        L = max(len(f) for f in fa)
        mp = np.zeros((N, N, L, L), dtype=np.float32)
        pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
        posts = self.batch_pair_posteriors(
            [fa[i].seq for i, _ in pairs], [fa[j].seq for _, j in pairs], device
        )
        for (i, j), p in zip(pairs, posts):
            mp[i, j, : p.shape[0], : p.shape[1]] = p
            mp[j, i, : p.shape[1], : p.shape[0]] = p.T
        for i in range(N):
            mp[i, i][np.arange(len(fa[i])), np.arange(len(fa[i]))] = 1.0
        return mp


class ProbCons(AlignModel):
    """ProbCons-RNA pair-HMM (default -a ProbCons)."""

    def batch_pair_posteriors(self, seqs1, seqs2, device):
        from dafs_tpu_torch.ops import pairhmm

        return pairhmm.batch_posteriors(seqs1, seqs2, self.th, device)
