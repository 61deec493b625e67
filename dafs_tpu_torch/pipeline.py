"""End-to-end DAFS pipeline (class DAFS, src/dafs.cpp:71-153, run at
:1781-1889), port of `dafs_tpu/pipeline.py`.

Host Python orchestrates (guide tree, projections, output); the numerics
(posterior models, PCT products, similarity DP, the DD subgradient loop,
final structure decode) run on `device`.

The ported slice is the default path without the RNAalifold consensus mix:
it equals `dafs_tpu.pipeline.Dafs(ProbCons(th_a), RNAfold(True, CUTOFF),
Options(use_alifold=False), alifold_model=None)`, which skips the mix in
the merges AND in the final structure.  (The JAX CLI's `--no-alifold` keeps
the mix in the final structure.)  Options outside the slice raise
`NotImplementedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import io
import time

import numpy as np
import torch

from dafs_tpu_torch import consistency, dd, guide_tree, projection
from dafs_tpu_torch.fasta import Fasta
from dafs_tpu_torch.ops import nussinov
from dafs_tpu_torch.typedefs import AlnRow, gapped_seq
from dafs_tpu_torch.utils.log import logger

F = np.float32

_QUEUE = "is not ported yet (ROADMAP.md, port queue: {})"
NOT_PORTED = {
    "use_alifold": "the RNAalifold consensus mix " + _QUEUE.format("alifold consensus"),
    "use_bp_update": "--bp-update " + _QUEUE.format("bp-update"),
    "use_bp_update1": "--bp-update1 " + _QUEUE.format("bp-update"),
    "fold_decoder": "--fold-decoder IPknot / --ipknot " + _QUEUE.format("IPknot"),
    "verbose": "-v 2 (per-iteration dumps) " + _QUEUE.format("-v 2"),
    "t_max": "-m 0 (the exact ILP) " + _QUEUE.format("-m 0"),
    "n_refinement": "-r (iterative refinement) " + _QUEUE.format("refinement"),
    "w_pct_f": "-f (four-way PCT) " + _QUEUE.format("four-way PCT"),
    "aux": "reading or writing aux files " + _QUEUE.format("aux files"),
    "dd_update": "the adagrad and adam DD update rules " + _QUEUE.format("adagrad/adam"),
    "dd_host": "the host-loop DD with native decoders " + _QUEUE.format("host DD"),
    "align_model": "-a CONTRAlign " + _QUEUE.format("CONTRAlign"),
    "fold_model": "-s CONTRAfold " + _QUEUE.format("CONTRAfold"),
    "param_file": "-P (parameter files) " + _QUEUE.format("-P"),
}


@dataclasses.dataclass
class Options:
    w: float = 4.0
    eta0: float = 0.5
    t_max: int = 600
    n_refinement: int = 0
    w_pct_a: float = 0.25
    w_pct_s: float = 0.25
    w_pct_f: float = 0.0
    th_a: float = 0.01
    th_s: tuple = (0.2,)
    th_s1: tuple | None = None  # defaults to th_s
    use_alifold: bool = False
    use_bp_update: bool = False
    use_bp_update1: bool = False
    fold_decoder: str = "Nussinov"
    verbose: int = 0
    save_align_aux: str | None = None
    save_fold_aux: str | None = None
    dd_update: str = "subgradient"
    dd_host: bool = False

    def check_slice(self) -> None:
        """Raise NotImplementedError for any option outside the slice."""
        bad = {
            "use_alifold": self.use_alifold,
            "use_bp_update": self.use_bp_update,
            "use_bp_update1": self.use_bp_update1,
            "fold_decoder": self.fold_decoder != "Nussinov",
            "verbose": self.verbose >= 2,
            "t_max": self.t_max == 0,
            "n_refinement": self.n_refinement > 0,
            "w_pct_f": self.w_pct_f != 0.0,
            "aux": bool(self.save_align_aux or self.save_fold_aux),
            "dd_update": self.dd_update != "subgradient",
            "dd_host": self.dd_host,
        }
        for key, on in bad.items():
            if on:
                raise NotImplementedError(NOT_PORTED[key])


class Dafs:
    def __init__(self, align_model, fold_model, opts: Options, device="cuda"):
        opts.check_slice()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        self.a_model = align_model
        self.s_model = fold_model
        self.o = opts
        if self.o.th_s1 is None:
            self.o.th_s1 = self.o.th_s

    # -- decoders ---------------------------------------------------------

    def _decode_structure(self, p: np.ndarray, th_list) -> tuple[np.ndarray, str]:
        """s_decoder1_->decode(p, ss, str): final common structure."""
        L = p.shape[0]
        P = -(-L // 32) * 32
        smp = np.full((P, P), np.float32(0.0 - F(th_list[0])), np.float32)
        smp[:L, :L] = np.float32(p - F(th_list[0]))
        _, ss = nussinov.decode(
            torch.from_numpy(smp[None]).to(self.device),
            torch.tensor([L], dtype=torch.int32, device=self.device),
        )
        ss = ss[0, :L].cpu().numpy().astype(np.int64)
        s = ["."] * L
        for i in range(L):
            if ss[i] >= 0:
                s[i] = "("
                s[ss[i]] = ")"
        return ss, "".join(s)

    # -- merge ------------------------------------------------------------

    def _merge_inputs(self, aln1, aln2):
        """Host prep of one merge: averaged p_x/p_y and p_z
        (src/dafs.cpp:913-934), without the consensus mix."""
        p_x = projection.average_basepairing_probability(self.bp, aln1)
        p_y = projection.average_basepairing_probability(self.bp, aln2)
        p_z = projection.average_matching_probability(self.mp, aln1, aln2)
        return p_x, p_y, p_z

    @staticmethod
    def _merge_finish(x, y, z, aln1, aln2):
        """Project one solved merge back to (ss, aln) (src/dafs.cpp:944-951)."""
        aln = projection.project_alignment(aln1, aln2, z)
        xx, yy = projection.project_secondary_structure(x, y, z)
        ss = np.where(xx == yy, xx, -1)
        return ss, aln

    def _align(self, node: int):
        """Progressive alignment under `node` (src/dafs.cpp:1499-1537).

        The reference recursion is strictly serial; here the merges whose
        children are both complete are solved together, one batched DD solve
        per layer, with per-merge results equal to the serial path."""
        state: dict[int, tuple] = {}
        internal = []
        stack = [node]
        while stack:
            n = stack.pop()
            _sc, (a, b) = self.tree[n]
            if a == -1:
                state[n] = (0.0, None, [AlnRow(n, np.ones(len(self.fa[n]), dtype=bool))])
            else:
                internal.append(n)
                stack += [a, b]
        pending = set(internal)
        while pending:
            layer = [
                n for n in sorted(pending)
                if self.tree[n][1][0] in state and self.tree[n][1][1] in state
            ]
            t0 = time.perf_counter()
            alns = [
                (state[self.tree[n][1][0]][2], state[self.tree[n][1][1]][2])
                for n in layer
            ]
            probs = [
                (*self._merge_inputs(a1, a2), len(a1), len(a2)) for a1, a2 in alns
            ]
            t1 = time.perf_counter()
            sols = dd.solve_by_dd_batch(
                probs,
                w=self.o.w, th_s=list(self.o.th_s), th_a=self.o.th_a,
                eta0=self.o.eta0, t_max=self.o.t_max, device=self.device,
            )
            t2 = time.perf_counter()
            for n, (s, x, y, z), (aln1, aln2) in zip(layer, sols, alns):
                ss, aln = self._merge_finish(x, y, z, aln1, aln2)
                state[n] = (s, ss, aln)
                pending.discard(n)
            logger.info(
                "merge layer (%d merges): avg %.2fs, solve %.2fs, project %.2fs",
                len(layer), t1 - t0, t2 - t1, time.perf_counter() - t2,
            )
        return state[node]

    # -- main -------------------------------------------------------------

    def run(self, fa: list[Fasta]) -> str:
        phases: dict[str, float] = {}
        t0 = time.perf_counter()

        def _phase(name):
            nonlocal t0
            t1 = time.perf_counter()
            phases[name] = t1 - t0
            logger.info("phase %s: %.2fs", name, t1 - t0)
            t0 = t1

        self.fa = fa
        lens = [len(f) for f in fa]
        out = io.StringIO()

        self.bp = self.s_model.all_seqs(fa, self.device)
        _phase("fold")
        self.mp = self.a_model.all_pairs(fa, self.device)
        _phase("align")
        sim = consistency.similarity_matrix(self.mp, lens, self.device)
        _phase("similarity")
        if self.o.w_pct_s != 0.0:
            self.bp = consistency.relax_basepairing_probability(
                self.bp, self.mp, sim, lens, self.o.w_pct_s, self.device
            )
        if self.o.w_pct_a != 0.0:
            self.mp = consistency.relax_matching_probability(
                self.mp, sim, lens, self.o.w_pct_a, self.device
            )
        _phase("PCT")
        self.tree = guide_tree.build_tree(sim)
        tree_line = guide_tree.print_tree(self.tree, [f.name for f in fa])
        out.write(tree_line + "\n")

        s, ss, aln = self._align(len(self.tree) - 1)
        _phase("merges")

        # final common structure (src/dafs.cpp:1857-1873), without the mix
        p = projection.average_basepairing_probability(self.bp, aln)
        ss, sstr = self._decode_structure(p, self.o.th_s1)
        _phase("final decode")

        aln_sorted = sorted(aln, key=lambda r: r.seq_id)
        out.write(">SS_cons\n")
        out.write(sstr + "\n")
        for row in aln_sorted:
            out.write("> " + fa[row.seq_id].name + "\n")
            out.write(gapped_seq(fa[row.seq_id].seq, row.mask) + "\n")
        # structured result for the Python API (dafs_tpu_torch.align_and_fold)
        self.result = dict(
            tree=tree_line,
            ss_cons=sstr,
            names=[fa[r.seq_id].name for r in aln_sorted],
            rows=[gapped_seq(fa[r.seq_id].seq, r.mask) for r in aln_sorted],
            score=float(s),
            phase_seconds=phases,
            similarity=sim,
        )
        return out.getvalue()
