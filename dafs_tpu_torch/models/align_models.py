"""Alignment models: producers of match-probability matrices.

Port of `dafs_tpu/models/align_models.py` for the ProbCons pair-HMM (the
default `-a ProbCons`) and the CONTRAlign pair-CRF (`-a CONTRAlign`): for
every unordered sequence pair, a dense match posterior matrix thresholded at
`th` (entries kept strictly greater), all N*(N-1)/2 pairs batched into one
padded run on `device`.  `AUXAlign` (`--align-aux`) reads the matrices from
a file instead.
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
        from dafs_tpu_torch.parallel import mesh

        devices = mesh.work_devices(device)
        if len(devices) > 1:
            return mesh.sharded_pair_posteriors(seqs1, seqs2, self.th, devices)
        return pairhmm.batch_posteriors(seqs1, seqs2, self.th, device)


class CONTRAlign(AlignModel):
    """CONTRAlign pair-CRF (-a CONTRAlign)."""

    def batch_pair_posteriors(self, seqs1, seqs2, device):
        from dafs_tpu_torch.ops import paircrf

        return paircrf.batch_posteriors(seqs1, seqs2, self.th, device)


class AUXAlign(AlignModel):
    """Precomputed match posteriors from the reference's text format
    (`> x y` header, then 1-based `i k:p ...` rows; src/align.cpp:204-247).
    The values are taken as they are, without the threshold."""

    def __init__(self, path: str, th: float):
        super().__init__(th)
        self.path = path

    def all_pairs(self, fa: list[Fasta], device) -> np.ndarray:
        N = len(fa)
        L = max(len(f) for f in fa)
        mp = np.zeros((N, N, L, L), dtype=np.float32)
        x = y = None
        with open(self.path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == ">":
                    x, y = int(parts[1]) - 1, int(parts[2]) - 1
                else:
                    i = int(parts[0]) - 1
                    for tok in parts[1:]:
                        k, p = tok.split(":")
                        mp[x, y, i, int(k) - 1] = float(p)
        for i in range(N):
            for j in range(i + 1, N):
                mp[j, i, : len(fa[j]), : len(fa[i])] = mp[i, j, : len(fa[i]), : len(fa[j])].T
        for i in range(N):
            mp[i, i][np.arange(len(fa[i])), np.arange(len(fa[i]))] = 1.0
        return mp


def by_name(name: str, th: float) -> AlignModel:
    """The model of `-a NAME`."""
    models = {"ProbCons": ProbCons, "CONTRAlign": CONTRAlign}
    if name not in models:
        raise ValueError(f"unknown alignment model {name!r}; one of {sorted(models)}")
    return models[name](th)
