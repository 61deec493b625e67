"""The reference's family pipeline: what `dafs_tpu_torch.pipeline.Dafs.run`
computes for one family, stage by stage, from the same records.

`Reference(options, fold_model, align_model, device)` holds the options of
one configuration.  `posteriors(seqs)` gives the fold's and the aligner's
posteriors after PCT and the similarity matrix; `merge_inputs` the averaged
(and consensus-mixed) inputs of one merge; `final_p` the final structure's
input; `update_bp` the bp-update of an input (`--bp-update`,
`--bp-update1`), which both of those take where the options ask for it;
`replay_dd` the device DD loop on a layer of merges; `decode` the
structure of an input.  Every function reads only its arguments and the
parameter files.

The fold and align models are found by name, one file each under the
benchmark folder's `reference/`, so that a configuration of other models
comes as added files:

- `fold/<fold_model>.py`: `posteriors(seqs, device)`, each sequence's
  unthresholded (len, len) float32 posteriors, and `CONSENSUS_LEAVES`,
  whether a group of one sequence takes its consensus from them (where
  `Dafs.run` hands them over: McCaskill under the consensus's own
  parameters); optionally `constrained_posteriors(seqs, constraints,
  device)`, each sequence's posteriors under its constraint string, cut at
  CUTOFF (the bp-update's re-fold; a configuration with bp-update needs it);
- `align/<align_model>.py`: `posteriors(seqs1, seqs2, th_a, device)`, each
  pair's match posteriors, entries kept above `th_a`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os

import numpy as np
import torch

from portbench.reference import alifold, consistency, dd, guide_tree, nussinov, projection
from portbench.reference.typedefs import CUTOFF, AlnRow


PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bracket of each level of `th_s` in a decoded structure (src/dafs.cpp)
LEFT_BRACKETS = "([{<ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def model_file(kind: str, name: str, root: str = PORTBENCH) -> str:
    """The reference file of the `kind` ("fold" or "align") model `name`
    in the benchmark folder `root` (a test's may be elsewhere)."""
    return os.path.join(root, "reference", kind, f"{name}.py")


def load_model(kind: str, name: str, root: str = PORTBENCH):
    path = model_file(kind, name, root)
    spec = importlib.util.spec_from_file_location(f"portbench_reference_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Record:
    name: str
    seq: str


class Reference:
    def __init__(self, options: dict, fold_model: str, align_model: str, device,
                 tf32: bool = False, root: str = PORTBENCH):
        self.o = dict(options)
        # float32 matrix products in full precision; TF32 only for the
        # control (`check.control_numbers`)
        self.tf32 = tf32
        self.o.setdefault("th_s1", self.o["th_s"])
        self.fold = load_model("fold", fold_model, root)
        self.align = load_model("align", align_model, root)
        self.device = torch.device(device)
        # the consensus takes the BL* parameters exactly under "Boltzmann"
        self.alifold = alifold.Alifold(0.0, bl=fold_model == "Boltzmann")

    # -- fold, align, similarity, PCT -------------------------------------

    def _fold(self, seqs):
        """(N, L, L) posteriors above CUTOFF; the fold's own unthresholded
        posteriors serve the consensus of one sequence where the model says
        so."""
        posts = self.fold.posteriors(seqs, self.device)
        self.alifold.leaves = dict(zip(seqs, posts)) if self.fold.CONSENSUS_LEAVES else {}
        L = max(len(s) for s in seqs)
        bp = np.zeros((len(seqs), L, L), np.float32)
        for i, p in enumerate(posts):
            bp[i, : p.shape[0], : p.shape[1]] = np.where(p > CUTOFF, p, np.float32(0.0))
        return bp

    def _align(self, seqs):
        """(N, N, L, L) match posteriors of every pair, transposes below,
        identity on the diagonal."""
        N, L = len(seqs), max(len(s) for s in seqs)
        pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
        posts = self.align.posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
                                      self.o["th_a"], self.device)
        mp = np.zeros((N, N, L, L), np.float32)
        for (i, j), p in zip(pairs, posts):
            mp[i, j, : p.shape[0], : p.shape[1]] = p
            mp[j, i, : p.shape[1], : p.shape[0]] = p.T
        for i in range(N):
            mp[i, i][np.arange(len(seqs[i])), np.arange(len(seqs[i]))] = 1.0
        return mp

    def posteriors(self, seqs: list[str]) -> dict:
        """bp and mp after PCT, and the similarity matrix, in the order
        `Dafs.run` takes them (the pair PCT reads the match posteriors
        before their own PCT)."""
        with self._precision():
            lens = [len(s) for s in seqs]
            bp = self._fold(seqs)
            mp = self._align(seqs)
            sim = consistency.similarity_matrix(mp, lens, self.device)
            if self.o["w_pct_s"] != 0.0:
                bp = consistency.relax_basepairing_probability(
                    bp, mp, sim, lens, self.o["w_pct_s"], self.device)
            if self.o["w_pct_a"] != 0.0:
                mp = consistency.relax_matching_probability(
                    mp, sim, lens, self.o["w_pct_a"], self.device)
        return dict(bp=bp, mp=mp, sim=sim)

    @staticmethod
    def tree(sim: np.ndarray):
        return guide_tree.build_tree(sim)

    # -- merges and the final structure -----------------------------------

    @contextlib.contextmanager
    def _precision(self):
        """TF32 as this reference computes, restored on exit."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _avg_bp(self, bp, aln, recs, use_alifold):
        with self._precision():
            ali = self.alifold.consensus_bp(aln, recs, self.device) if use_alifold else None
        return projection.average_basepairing_probability(bp, aln, ali)

    def _input(self, bp, recs, aln, use_alifold, update, th, under):
        """(the input made of the group `aln`, its average before the
        bp-update): the average twice without `update`; else its bp-update
        under `under` ((ss, sstr), the structure the program's update ran
        under) or, where that is None, under the reference's own decode of
        the average at `th`."""
        avg = self._avg_bp(bp, aln, recs, use_alifold)
        if not update:
            return avg, avg
        if under is None:
            ss = self.decode(avg, th)
            under = ss, brackets(ss)
        return self.update_bp(avg, *under, aln, recs, use_alifold), avg

    def merge_inputs(self, bp, mp, recs, aln1, aln2, under=(None, None)):
        """((p_x, p_y, p_z), (a_x, a_y)) of the merge of `aln1` and `aln2`:
        the DD's inputs, and each side's average before its bp-update
        (`use_bp_update`; p_x and p_y themselves without it), the update of
        side k made under `under[k]` (see `_input`).  The consensus calls go
        x, x's update, y, y's update, as in `Dafs._merge_inputs`: the
        pf-scale warm start is shared by a shape's constrained and
        unconstrained calls."""
        upd = self.o.get("use_bp_update", False)
        sides = [self._input(bp, recs, aln, self.o["use_alifold"], upd, self.o["th_s"][0], u)
                 for aln, u in zip((aln1, aln2), under)]
        p_z = projection.average_matching_probability(mp, aln1, aln2)
        return (sides[0][0], sides[1][0], p_z), (sides[0][1], sides[1][1])

    def final_p(self, bp, recs, aln, under=None):
        """(the final decode's input, its average before the bp-update
        (`use_bp_update1`; the input itself without it)): the consensus is
        always mixed in; the update is made under `under` (see `_input`)."""
        return self._input(bp, recs, aln, True, self.o.get("use_bp_update1", False),
                           self.o["th_s1"][0], under)

    def update_bp(self, p, ss, sstr, aln, recs, use_alifold: bool) -> np.ndarray:
        """The bp-update of `p` (`Dafs._update_bp`, src/dafs.cpp:609-711):
        every sequence of the group `aln` folded again under the structure
        (`ss`, `sstr`) decoded from `p`, once per bracket level of `th_s`
        (the fold reference's `constrained_posteriors`), and the results
        averaged; with the consensus, its constrained runs averaged in too."""
        L = int(aln[0].mask.shape[0])
        N = len(aln)
        plevel = len(self.o["th_s"])
        out = np.zeros((L, L), dtype=np.float32)
        # every (sequence, constraint) re-fold goes into one batched call
        tasks: list[tuple[int, np.ndarray, str]] = []
        for row in aln:
            s = row.seq_id
            ls = len(recs[s].seq)
            idx = np.nonzero(row.mask)[0]
            rev = np.full(L, -1, dtype=np.int64)
            rev[idx] = np.arange(len(idx))
            for plv in range(plevel):
                con = ["?"] * ls
                for i in range(L):
                    if ss[i] >= 0 and rev[i] >= 0 and rev[ss[i]] >= 0:
                        if sstr[i] == LEFT_BRACKETS[plv]:
                            con[rev[i]] = "("
                            con[rev[ss[i]]] = ")"
                        else:
                            con[rev[i]] = con[rev[ss[i]]] = "."
                tasks.append((s, idx, "".join(con)))
        with self._precision():
            bps = self.fold.constrained_posteriors(
                [recs[s].seq for s, _, _ in tasks], [c for _, _, c in tasks], self.device)
        for (s, idx, _), bp in zip(tasks, bps):
            out[np.ix_(idx, idx)] += np.float32(bp / np.float32(N))
        if use_alifold:
            for plv in range(plevel):
                con = ["?"] * L
                for i in range(L):
                    if ss[i] >= 0:
                        if sstr[i] == LEFT_BRACKETS[plv]:
                            con[i] = "("
                            con[ss[i]] = ")"
                        else:
                            con[i] = con[ss[i]] = "."
                with self._precision():
                    out += self.alifold.consensus_bp(aln, recs, self.device, "".join(con))
            iu = np.triu_indices(L, 1)
            out[iu] = np.float32(out[iu] / np.float32(2.0))
        out[np.tril_indices(L, 0)] = 0.0
        out[out <= CUTOFF] = 0.0
        return out

    def replay_dd(self, problems: list, t_cap: int | None = None) -> list:
        """The device DD of one layer of merges, as `dd.solve_by_dd_batch`
        solves it, stopped after `t_cap` iterations where given (a merge's
        iterations do not depend on the cap until it is reached):
        [(s, x, y, z, iterations, violations)]."""
        stats: list = []
        t_max = self.o["t_max"] if t_cap is None else min(t_cap, self.o["t_max"])
        sols = dd.solve_by_dd_batch(
            problems, w=self.o["w"], th_s=list(self.o["th_s"]), th_a=self.o["th_a"],
            eta0=self.o["eta0"], t_max=t_max, device=self.device,
            update_rule=self.o.get("dd_update", "subgradient"), stats=stats)
        return [(*sol, *st) for sol, st in zip(sols, stats)]

    def decode(self, p: np.ndarray, th: float) -> np.ndarray:
        """The Nussinov structure of `p` at `th` (`Dafs._decode_structure`):
        ss[i] = j for every pair, -1 elsewhere."""
        L = p.shape[0]
        P = -(-L // 32) * 32
        smp = np.full((P, P), np.float32(0.0 - np.float32(th)), np.float32)
        smp[:L, :L] = np.float32(p - np.float32(th))
        _, ss = nussinov.decode(torch.from_numpy(smp[None]).to(self.device),
                                torch.tensor([L], dtype=torch.int32, device=self.device))
        return ss[0, :L].cpu().numpy().astype(np.int64)


def pairs_of(ss: np.ndarray) -> list[tuple[int, int]]:
    return [(i, int(j)) for i, j in enumerate(ss) if j > i]


def brackets(ss: np.ndarray) -> str:
    """The bracket string of a decoded structure, as `Dafs._decode_structure`
    writes it."""
    s = ["."] * len(ss)
    for i, j in pairs_of(ss):
        s[i], s[j] = "(", ")"
    return "".join(s)


def sub_alignment(rows: list[str], ids: list[int]) -> list[AlnRow]:
    """The alignment of the sequences `ids` that the rows imply: their gap
    masks, with the columns that are gaps in all of them dropped (a merge
    only inserts such columns into its children)."""
    masks = np.array([[c != "-" for c in rows[i]] for i in ids], dtype=bool)
    keep = masks.any(axis=0)
    return [AlnRow(i, m[keep]) for i, m in zip(ids, masks)]


def leaves_under(tree, node: int) -> list[int]:
    l, r = tree[node][1]
    if l == -1:
        return [node]
    return leaves_under(tree, l) + leaves_under(tree, r)


def layers(tree, n: int) -> list[list[int]]:
    """The merges of the tree in the order `Dafs._align` solves them: one
    layer at a time, each the sorted merges whose children are done."""
    done = set(range(n))
    pending = set(range(n, 2 * n - 1))
    out = []
    while pending:
        layer = sorted(m for m in pending
                       if tree[m][1][0] in done and tree[m][1][1] in done)
        out.append(layer)
        done |= set(layer)
        pending -= set(layer)
    return out
