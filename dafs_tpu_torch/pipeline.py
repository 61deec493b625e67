"""End-to-end DAFS pipeline (class DAFS, src/dafs.cpp:71-153, run at
:1781-1889), port of `dafs_tpu/pipeline.py`.

Host Python orchestrates (guide tree, projections, output); the numerics
(posterior models, PCT products, similarity DP, RNAalifold consensus, the
DD loop, final structure decode) run on `device`.  Where the work mesh of
`device` has more than one shard (`parallel.mesh`: "cuda" is every visible
card), the McCaskill fold, the ProbCons all-pairs stage and the two 3-way
PCTs split over it, as in `dafs_tpu`; the rest runs on `device`.

`Dafs(align_model, fold_model, Options(...), alifold_model=Alifold(0.0,
bl=...))` equals the JAX package's `Dafs` of the same arguments for every
option of one device: the ProbCons, CONTRAlign or aux-file alignment model,
the McCaskill (BL* or Vienna), CONTRAfold or aux-file fold model, bp-update
(`use_bp_update`, `use_bp_update1`), the host merge solvers
(`fold_decoder="IPknot"`, `verbose=2`, `dd_host`, `t_max=0`), the DD update
rules (`dd_update`), four-way PCT (`w_pct_f`), refinement (`n_refinement`)
and the aux dumps (`save_align_aux`, `save_fold_aux`).  The consensus is
mixed into every merge when `Options.use_alifold` is set, and into the final
structure whenever an `alifold_model` is given (use_alifold1_ is always true
in the reference).

The merges of the device DD are solved one guide-tree layer at a time
(`dd.solve_by_dd_batch`).  The host solvers take the reference's serial
recursion instead, one merge at a time in its order (left subtree, right
subtree, then the merge): `dd.solve_by_ip` under `t_max=0`, else
`dd.solve_by_dd_ipknot` with the IPknot ILPs (IPknot) or the port's
Nussinov decoder (`verbose >= 2`, `dd_host`).  Refinement merges one random
bipartition of the finished alignment at a time with the same solver.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import sys
import time

import numpy as np
import torch

from dafs_tpu_torch import consistency, dd, guide_tree, projection
from dafs_tpu_torch.fasta import Fasta
from dafs_tpu_torch.models.fold_models import RNAfold
from dafs_tpu_torch.ops import nussinov
from dafs_tpu_torch.typedefs import CUTOFF, AlnRow, gapped_seq
from dafs_tpu_torch.utils.crand import GlibcRand
from dafs_tpu_torch.utils.log import logger

F = np.float32


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
    use_alifold: bool = True
    use_bp_update: bool = False
    use_bp_update1: bool = False
    fold_decoder: str = "Nussinov"  # or "IPknot"
    verbose: int = 0
    save_align_aux: str | None = None  # dump mp (the reference's text format)
    save_fold_aux: str | None = None   # dump bp
    dd_update: str = "subgradient"  # or "adagrad" / "adam" (src/dafs.cpp:67-69)
    dd_host: bool = False  # the host-loop DD with the port's Nussinov decoder


class Dafs:
    def __init__(self, align_model, fold_model, opts: Options, alifold_model=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        self.a_model = align_model
        self.s_model = fold_model
        self.alifold = alifold_model
        self.o = opts
        if self.o.th_s1 is None:
            self.o.th_s1 = self.o.th_s
        # (iterations, violations at exit) of each merge in solve order, one
        # list for the host DD loop and one for the device DD
        self.host_dd: list[tuple[int, int]] = []
        self.device_dd: list[tuple[int, int]] = []
        # per refinement: the two groups of sequence ids, the score before
        # it and the merge's score
        self.refinements: list[dict] = []
        # DAFS::refine's bare rand(): one glibc seed-1 stream for the life of
        # the object, as in the JAX package
        self._rand = GlibcRand()

    # -- decoders ---------------------------------------------------------

    def _decode_structure(self, p: np.ndarray, th_list) -> tuple[np.ndarray, str]:
        """s_decoder1_->decode(p, ss, str): final common structure."""
        if self.o.fold_decoder == "IPknot":
            from dafs_tpu_torch.decoders_ip import ipknot

            ss, sstr, _ = ipknot.decode(p, th_list)
            return ss, sstr
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

    # -- averaging with alifold mix --------------------------------------

    def _avg_bp(self, aln, use_alifold: bool) -> np.ndarray:
        ali = None
        if use_alifold and self.alifold is not None:
            ali = self.alifold.consensus_bp(aln, self.fa, self.device)
        return projection.average_basepairing_probability(self.bp, aln, ali)

    def _update_bp(self, p, ss, sstr, aln, use_alifold) -> np.ndarray:
        """Constrained BP re-estimation (src/dafs.cpp:609-711): every
        sequence of `aln` is folded again under the structure `ss` decoded
        from `p`, once per bracket level of `th_s`, and the results averaged;
        with the consensus, its constrained runs are averaged in too."""
        L = int(aln[0].mask.shape[0])
        N = len(aln)
        plevel = len(self.o.th_s)
        out = np.zeros((L, L), dtype=np.float32)
        left_brackets = "([{<ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        # every (sequence, constraint) re-fold goes into one batched call
        tasks: list[tuple[int, np.ndarray, str]] = []
        for row in aln:
            s = row.seq_id
            ls = len(self.fa[s].seq)
            idx = np.nonzero(row.mask)[0]
            rev = np.full(L, -1, dtype=np.int64)
            rev[idx] = np.arange(len(idx))
            for plv in range(plevel):
                con = ["?"] * ls
                for i in range(L):
                    if ss[i] >= 0 and rev[i] >= 0 and rev[ss[i]] >= 0:
                        if sstr[i] == left_brackets[plv]:
                            con[rev[i]] = "("
                            con[rev[ss[i]]] = ")"
                        else:
                            con[rev[i]] = con[rev[ss[i]]] = "."
                tasks.append((s, idx, "".join(con)))
        bps = self.s_model.batch_bp_posteriors(
            [self.fa[s].seq for s, _, _ in tasks], self.device,
            constraints=[c for _, _, c in tasks],
        )
        for (s, idx, _), bp in zip(tasks, bps):
            out[np.ix_(idx, idx)] += np.float32(bp / F(N))
        if use_alifold and self.alifold is not None:
            for plv in range(plevel):
                con = ["?"] * L
                for i in range(L):
                    if ss[i] >= 0:
                        if sstr[i] == left_brackets[plv]:
                            con[i] = "("
                            con[ss[i]] = ")"
                        else:
                            con[i] = con[ss[i]] = "."
                out += self.alifold.consensus_bp(aln, self.fa, self.device, "".join(con))
            iu = np.triu_indices(L, 1)
            out[iu] = np.float32(out[iu] / F(2.0))
        out[np.tril_indices(L, 0)] = 0.0
        out[out <= CUTOFF] = 0.0
        return out

    # -- merge ------------------------------------------------------------

    def _merge_inputs(self, aln1, aln2):
        """Host prep of one merge: averaged p_x/p_y (with the consensus mix
        when `use_alifold` is set, then bp-update when `use_bp_update` is)
        and p_z (src/dafs.cpp:913-934).  The order of the consensus calls is
        the JAX package's (x, its update, y, its update): the pf-scale warm
        start is shared by constrained and unconstrained calls of one shape."""
        ps = []
        for aln in (aln1, aln2):
            p = self._avg_bp(aln, self.o.use_alifold)
            if self.o.use_bp_update:
                ss0, str0 = self._decode_structure(p, self.o.th_s)
                p = self._update_bp(p, ss0, str0, aln, self.o.use_alifold)
            ps.append(p)
        p_z = projection.average_matching_probability(self.mp, aln1, aln2)
        return ps[0], ps[1], p_z

    def _output_verbose(self, x, y, z, aln1, aln2):
        """Per-DD-iteration dump to standard output (output_verbose,
        src/dafs.cpp:875-894)."""
        aln = projection.project_alignment(aln1, aln2, z)
        xx, yy = projection.project_secondary_structure(x, y, z)

        def brackets(ss):
            s = ["."] * len(ss)
            for i in range(len(ss)):
                if ss[i] >= 0:
                    s[i] = "("
                    s[ss[i]] = ")"
            return "".join(s)

        out = sys.stdout
        for row in aln[: len(aln1)]:
            out.write("> " + self.fa[row.seq_id].name + "\n")
            out.write(gapped_seq(self.fa[row.seq_id].seq, row.mask) + "\n")
        out.write(brackets(xx) + "\n")
        for row in aln[len(aln1):]:
            out.write("> " + self.fa[row.seq_id].name + "\n")
            out.write(gapped_seq(self.fa[row.seq_id].seq, row.mask) + "\n")
        out.write(brackets(yy) + "\n\n")

    @staticmethod
    def _merge_finish(x, y, z, aln1, aln2):
        """Project one solved merge back to (ss, aln) (src/dafs.cpp:944-951)."""
        aln = projection.project_alignment(aln1, aln2, z)
        xx, yy = projection.project_secondary_structure(x, y, z)
        ss = np.where(xx == yy, xx, -1)
        return ss, aln

    def _solver(self, aln1, aln2, trace):
        """The solver of one merge (src/dafs.cpp:110-115, 875-894,
        1091-1092), as the JAX package dispatches it.  The host DD loop
        appends each iteration's (t, s, violated, eta) to `trace`; the host
        solvers take no update rule, as in the JAX package."""
        if self._can_batch_merges():
            return functools.partial(dd.solve_by_dd, device=self.device,
                                     update_rule=self.o.dd_update, stats=self.device_dd)
        if self.o.t_max == 0:
            # -m 0: the exact joint ILP
            return dd.solve_by_ip
        # IPknot's ILPs in the loop, else (-v 2, dd_host) the port's Nussinov
        # decoder; -v 2 dumps every iteration
        verbose_cb = (functools.partial(self._output_verbose, aln1=aln1, aln2=aln2)
                      if self.o.verbose >= 2 else None)
        return functools.partial(
            dd.solve_by_dd_ipknot, device=self.device, verbose_cb=verbose_cb,
            trace_cb=lambda *t: trace.append(t),
            structure_decoder="ipknot" if self.o.fold_decoder == "IPknot" else "nussinov")

    def _align_alignments(self, aln1, aln2, phases: dict):
        """One merge (src/dafs.cpp:913-981): of the serial recursion of the
        host solvers, or of refinement.  Returns (s, ss, aln); adds its
        seconds to `phases`."""
        t0 = time.perf_counter()
        p_x, p_y, p_z = self._merge_inputs(aln1, aln2)
        t1 = time.perf_counter()
        trace = []
        s, x, y, z = self._solver(aln1, aln2, trace)(
            p_x, p_y, p_z, len(aln1), len(aln2),
            w=self.o.w, th_s=list(self.o.th_s), th_a=self.o.th_a,
            eta0=self.o.eta0, t_max=self.o.t_max,
        )
        if trace:
            self.host_dd.append((len(trace), trace[-1][2]))
        t2 = time.perf_counter()
        ss, aln = self._merge_finish(x, y, z, aln1, aln2)
        t3 = time.perf_counter()
        self._add_merge_seconds(phases, t1 - t0, t2 - t1, t3 - t2)
        logger.info(
            "merge N1=%d N2=%d L=%d: avg+alifold %.2fs, solve %.2fs, project %.2fs",
            len(aln1), len(aln2), len(aln[0].mask), t1 - t0, t2 - t1, t3 - t2,
        )
        return s, ss, aln

    @staticmethod
    def _add_merge_seconds(phases, prep, solve, project):
        for name, sec in (("merge avg+alifold", prep), ("merge DD", solve),
                          ("merge project", project)):
            phases[name] = phases.get(name, 0.0) + sec

    def _can_batch_merges(self) -> bool:
        """The layered batched solver covers the device DD only; the ILP,
        IPknot and the host loops keep the reference's serial recursion."""
        return (
            self.o.t_max > 0
            and self.o.fold_decoder != "IPknot"
            and self.o.verbose < 2
            and not self.o.dd_host
        )

    def _align(self, node: int, phases: dict):
        """Progressive alignment under `node` (src/dafs.cpp:1499-1537).

        The reference recursion is strictly serial, and the host solvers
        keep it.  For the device DD, the merges whose children are both
        complete are solved together, one batched DD solve per layer, with
        per-merge results equal to the serial path.  Adds the host seconds
        of the input prep, the solves and the projections, summed over
        merges, to `phases`."""
        if not self._can_batch_merges():
            l, r = self.tree[node][1]
            if l == -1:
                return 0.0, None, [AlnRow(node, np.ones(len(self.fa[node]), dtype=bool))]
            _, _, aln1 = self._align(l, phases)
            _, _, aln2 = self._align(r, phases)
            return self._align_alignments(aln1, aln2, phases)
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
                update_rule=self.o.dd_update, stats=self.device_dd,
            )
            t2 = time.perf_counter()
            for n, (s, x, y, z), (aln1, aln2) in zip(layer, sols, alns):
                ss, aln = self._merge_finish(x, y, z, aln1, aln2)
                state[n] = (s, ss, aln)
                pending.discard(n)
            t3 = time.perf_counter()
            self._add_merge_seconds(phases, t1 - t0, t2 - t1, t3 - t2)
            logger.info(
                "merge layer (%d merges): avg+alifold %.2fs, solve %.2fs, project %.2fs",
                len(layer), t1 - t0, t2 - t1, t3 - t2,
            )
        return state[node]

    def _refine(self, aln, phases: dict):
        """Random bipartition refinement (src/dafs.cpp:1539-1576): rand() % 2
        puts each row in one of two groups (until both are non-empty), the
        columns that are all gaps in a group are dropped, and the two groups
        are merged again.  Returns the merge's (s, ss, aln)."""
        while True:
            group = [[], []]
            for i in range(len(aln)):
                group[self._rand.rand() % 2].append(i)
            if group[0] and group[1]:
                break
        self.refinements.append(dict(groups=[[aln[i].seq_id for i in g] for g in group]))
        parts = []
        for g in group:
            rows = [aln[i] for i in g]
            keep = np.stack([r.mask for r in rows]).any(axis=0)
            parts.append([AlnRow(r.seq_id, r.mask[keep]) for r in rows])
        return self._align_alignments(parts[0], parts[1], phases)

    def _save_aux(self, lens):
        """The aux dumps (src/align.cpp:206-228, src/fold.cpp:230-259):
        1-based `> x` / `> x y` headers, then one `i j:p ...` row per
        position, each p as `%.9g` (exact for a float32)."""
        N = len(lens)
        if self.o.save_fold_aux:
            with open(self.o.save_fold_aux, "w") as fh:
                for x in range(N):
                    fh.write(f"> {x+1}\n")
                    for i in range(lens[x]):
                        js = np.nonzero(self.bp[x, i, : lens[x]])[0]
                        fh.write(str(i + 1))
                        for j in js:
                            fh.write(f" {j+1}:{self.bp[x, i, j]:.9g}")
                        fh.write("\n")
        if self.o.save_align_aux:
            with open(self.o.save_align_aux, "w") as fh:
                for x in range(N - 1):
                    for y in range(x + 1, N):
                        fh.write(f"> {x+1} {y+1}\n")
                        for i in range(lens[x]):
                            ks = np.nonzero(self.mp[x, y, i, : lens[y]])[0]
                            fh.write(str(i + 1))
                            for k in ks:
                                fh.write(f" {k+1}:{self.mp[x, y, i, k]:.9g}")
                            fh.write("\n")

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
        self.host_dd, self.device_dd, self.refinements = [], [], []
        lens = [len(f) for f in fa]
        out = io.StringIO()

        # A group of one ungapped sequence takes its consensus from this same
        # McCaskill run, before the fold threshold (the single-sequence
        # route of ops/alifold.py), when the fold model is McCaskill under
        # the consensus's parameter set.
        seqs = [f.seq for f in fa]
        posts = None
        if (self.alifold is not None and isinstance(self.s_model, RNAfold)
                and self.alifold.bl == self.s_model.bl):
            posts = self.s_model.batch_bp_posteriors(seqs, self.device, th=0.0)
        self.bp = self.s_model.all_seqs(fa, self.device, posts)
        if self.alifold is not None:
            self.alifold.leaves = dict(zip(seqs, posts or []))
            first_call = len(self.alifold.calls)
        _phase("fold")
        self.mp = self.a_model.all_pairs(fa, self.device)
        _phase("align")
        if self.o.save_fold_aux or self.o.save_align_aux:
            self._save_aux(lens)
            _phase("save aux")
        if self.o.w_pct_f != 0.0:
            self.mp = consistency.relax_fourway_consistency(
                self.mp, self.bp, lens, self.o.w_pct_f, self.device
            )
            _phase("four-way PCT")
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

        s, ss, aln = self._align(len(self.tree) - 1, phases)
        t0 = time.perf_counter()
        # each refinement merge's own seconds stay out of the merge phases
        for _ in range(self.o.n_refinement):
            s_new, ss_new, aln_new = self._refine(aln, {})
            self.refinements[-1].update(s=float(s), s_new=float(s_new))
            if s_new > s:
                s, ss, aln = s_new, ss_new, aln_new
        if self.o.n_refinement:
            _phase("refinement")

        # final common structure (src/dafs.cpp:1857-1873); use_alifold1_ is
        # always true in the reference
        p = self._avg_bp(aln, use_alifold=True)
        _phase("final avg_bp (+alifold)")
        if self.o.use_bp_update1:
            ss0, str0 = self._decode_structure(p, self.o.th_s1)
            p = self._update_bp(p, ss0, str0, aln, use_alifold=True)
            _phase("final bp-update")
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
            consensus_calls=self.alifold.calls[first_call:] if self.alifold is not None else [],
            host_dd=list(self.host_dd),
            device_dd=list(self.device_dd),
            refinements=list(self.refinements),
        )
        return out.getvalue()
