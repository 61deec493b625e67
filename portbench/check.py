"""The comparison that decides a run's `correct`.

After the window, the program's state freed and its memory peak read, the
plain reference (`reference/`) recomputes a sample of the window's
families from the same records: the longest family the window finished
and others drawn from the seed (`checks/<cell>.json`: `families`).  The
numbers compared, each the worst over the sample, each with a limit in the
cell's checks file:

- `bp_err`, `mp_err`: the fold's base-pair and the aligner's match
  posteriors after PCT (`Dafs.bp`, `Dafs.mp`) against the reference's.
  Entries are cut at CUTOFF on both sides; where one side is cut and the
  other is not, the error is the kept value's distance above the cut.
- `sim_err`: the similarity matrix (`Result.similarity`): a max-plus DP
  that reorders no sum, so it is compared exactly.
- `merge_in_err`: the inputs of the sampled merges as the DD got them
  (p_x and p_y with the consensus mixed in, p_z), against the reference's
  from the same child alignments, cut as above.
- `final_in_err`: the final decode's input (the averaged posteriors of the
  whole alignment with the consensus mixed in) against the reference's,
  cut as above.
- `ss_bad`: 1 where `SS_cons` is not the reference decode's structure of
  the program's own final input (K3 decodes as the plain Nussinov does,
  ties included), and under bp-update 1 more for each structure that a
  sampled merge's side (`use_bp_update`; at `th_s[0]`) or the final input
  (`use_bp_update1`; at `th_s1[0]`) was updated under and that is not the
  reference decode of the program's own input to that update, or that the
  program made no update for.
- `tree_bad`: 1 where the guide tree differs from the one the reference
  builds from the program's similarity matrix.
- `rows_bad`: rows that are not their input sequence with gaps, and sampled
  merges whose DD alignment, projected, is not what the rows show.
- `dd_bad`: merges of the replayed layers whose DD result (score, both
  structures, the alignment, iterations, violations) differs from the
  reference DD's on the same inputs.  The layers replayed are the cheapest
  within the cell's `dd_replay_budget` (iterations x padded length), and
  the next one up to an iteration cap: a merge the program ran past the
  cap must not have ended before it in the reference.

The merges follow the program's own state: their child alignments are
read from the rows and its guide tree, their DD inputs from the program
(`merge_in_err` checks those inputs on their own).

Under bp-update (`Dafs._update_bp`, which the window's capture keeps: its
input, the structure it ran under, the group of rows and its output) the
updates are matched to the merges' sides and the final input by their group
(seq ids and gap masks).  Each update's input, the average before it, goes
into `merge_in_err` (`final_in_err` for the final) against the reference's
average; the updated input (the DD's p_x or p_y, or the final decode's
input) against the reference's update (`Reference.update_bp`) made under
the program's own structure, since a near-tie in the decode can flip on
rounding and move the re-folded posteriors by O(1); the structure itself is
held exactly by `ss_bad`.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.reference import family as F
from portbench.reference import projection
from portbench.reference.typedefs import CUTOFF

NUMBERS = ("bp_err", "mp_err", "sim_err", "merge_in_err", "final_in_err",
           "tree_bad", "rows_bad", "dd_bad", "ss_bad")


def cut_err(a: np.ndarray, b: np.ndarray, th: float = CUTOFF) -> float:
    """The largest gap between two matrices cut at `th`: |a - b| where both
    are kept, the kept value minus `th` where one side is cut; inf where
    the shapes differ."""
    if a.shape != b.shape:
        return float("inf")
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    both = (a != 0) & (b != 0)
    one = (a != 0) ^ (b != 0)
    err = np.abs(a - b)[both].max(initial=0.0)
    return float(max(err, (np.abs(a + b)[one] - th).max(initial=0.0)))


def _group(aln) -> tuple:
    """A group of rows as a bp-update saw it: its seq ids and gap masks."""
    return tuple((int(r.seq_id), np.asarray(r.mask, bool).tobytes()) for r in aln)


def _updates(cap: dict) -> dict:
    """The program's bp-updates of a family by their group."""
    return {_group(u["aln"]): u for u in cap.get("updates", [])}


def _under(u):
    """The structure a captured update ran under, None where none was made."""
    return None if u is None else (u["ss"], u["sstr"])


def _structure_bad(ref: F.Reference, u, th: float) -> int:
    """1 where the program made no update (`u` None) or where the structure
    it ran under is not the reference decode of its own input at `th`."""
    if u is None:
        return 1
    ss = ref.decode(u["p"], th)
    return int(not (np.array_equal(ss, u["ss"]) and F.brackets(ss) == u["sstr"]))


def _sample_merges(layers, k, rng) -> set[int]:
    """The root and k - 1 other merges drawn from `rng` (all for k None)."""
    merges = [m for layer in layers for m in layer]
    if k is None or k >= len(merges):
        return set(merges)
    rest = merges[:-1]
    pick = rng.choice(len(rest), size=k - 1, replace=False) if k > 1 else []
    return {merges[-1], *(rest[i] for i in pick)}


def _replay_layers(caps, budget) -> list[tuple[int, int | None]]:
    """The DD layers to replay, as (layer, iteration cap or None): the
    cheapest first (iterations x padded length) while their sum stays
    within `budget`, then the next one cut to what is left of it (at least
    8 iterations)."""
    cost = []
    for li, (problems, _, stats) in enumerate(caps):
        P = max(-(-max(p[2].shape) // 32) * 32 for p in problems)
        cost.append((max(t for t, _ in stats) * P, P, li))
    out, left = [], budget
    for c, P, li in sorted(cost):
        if c <= left:
            out.append((li, None))
            left -= c
        else:
            if left // P >= 8:
                out.append((li, left // P))
            break
    return out


def check_family(ref: F.Reference, cap: dict) -> dict:
    """The numbers of one family: `cap` holds what the window's run of it
    produced (records, bp, mp, similarity, tree, rows, ss_cons, the DD
    layers as (problems, solutions, stats), the final decode's input, the
    bp-updates) and what `plan` chose of it."""
    seqs = [s for _, s in cap["records"]]
    recs = [F.Record(n, s) for n, s in cap["records"]]
    n = len(seqs)
    clock = [time.perf_counter()]
    post = ref.posteriors(seqs)
    clock.append(time.perf_counter())
    out = dict(bp_err=cut_err(cap["bp"], post["bp"]), mp_err=cut_err(cap["mp"], post["mp"]),
               sim_err=float(np.abs(cap["sim"].astype(np.float64) - post["sim"]).max()))
    tree = cap["tree"]
    out["tree_bad"] = int(F.Reference.tree(cap["sim"]) != tree)

    rows = cap["rows"]
    rows_bad = sum(r.replace("-", "") != s for r, s in zip(rows, seqs))
    rows_bad += sum(len(r) != len(rows[0]) for r in rows) + abs(len(rows) - n)
    layers = F.layers(tree, n)
    caps = cap["layers"]
    merge_in_err, dd_bad, ss_bad = 0.0, 0, 0
    updates = _updates(cap)
    update, update1 = ref.o.get("use_bp_update", False), ref.o.get("use_bp_update1", False)
    cap["compared"] = dict(merges=0, replayed=0, updates=0)
    if rows_bad or [len(x) for x in layers] != [len(p) for p, _, _ in caps]:
        # the rows or the schedule do not say which inputs belong to which
        # merge: nothing below can be compared
        out.update(rows_bad=max(rows_bad, 1), merge_in_err=float("inf"),
                   dd_bad=max(1, sum(map(len, layers))), final_in_err=float("inf"), ss_bad=1)
        return out
    for layer, (problems, sols, _) in zip(layers, caps):
        for m, prob, sol in zip(layer, problems, sols):
            if m not in cap["sampled_merges"]:
                continue
            l, r = tree[m][1]
            aln1 = F.sub_alignment(rows, F.leaves_under(tree, l))
            aln2 = F.sub_alignment(rows, F.leaves_under(tree, r))
            sides = [updates.get(_group(a)) for a in (aln1, aln2)]
            want, avgs = ref.merge_inputs(post["bp"], post["mp"], recs, aln1, aln2,
                                          under=[_under(u) for u in sides])
            merge_in_err = max(merge_in_err, *(cut_err(g, w) for g, w in zip(prob[:3], want)))
            if update:
                for u, avg in zip(sides, avgs):
                    ss_bad += _structure_bad(ref, u, ref.o["th_s"][0])
                    if u is not None:
                        merge_in_err = max(merge_in_err, cut_err(u["p"], avg))
                        cap["compared"]["updates"] += 1
            cap["compared"]["merges"] += 1
            got = projection.project_alignment(aln1, aln2, np.asarray(sol[3]))
            shown = F.sub_alignment(rows, F.leaves_under(tree, m))
            rows_bad += int([(a.seq_id, a.mask.tolist()) for a in got]
                            != [(a.seq_id, a.mask.tolist()) for a in shown])
    clock.append(time.perf_counter())
    for li, t_cap in cap["replayed_layers"]:
        problems, sols, stats = caps[li]
        for sol, st, want in zip(sols, stats, ref.replay_dd(problems, t_cap)):
            if t_cap is not None and st[0] > t_cap:
                # the program went on past the cap: so must the reference
                same = want[4] == t_cap
            else:
                same = (np.float32(sol[0]) == np.float32(want[0])
                        and all(np.array_equal(a, b) for a, b in zip(sol[1:4], want[1:4]))
                        and tuple(st) == tuple(want[4:6]))
            dd_bad += int(not same)
            cap["compared"]["replayed"] += 1
    clock.append(time.perf_counter())
    # the final alignment's rows in the program's order: the root's leaves
    aln = F.sub_alignment(rows, F.leaves_under(tree, len(tree) - 1))
    u = updates.get(_group(aln))
    p, avg = ref.final_p(post["bp"], recs, aln, under=_under(u))
    th = ref.o["th_s1"][0]
    final_in_err = cut_err(cap["final_p"], p)
    if update1:
        ss_bad += _structure_bad(ref, u, th)
        if u is not None:
            final_in_err = max(final_in_err, cut_err(u["p"], avg))
            cap["compared"]["updates"] += 1
    ss_bad += int(F.brackets(ref.decode(cap["final_p"], th)) != cap["ss_cons"])
    out.update(rows_bad=rows_bad, merge_in_err=merge_in_err, dd_bad=dd_bad,
               final_in_err=final_in_err, ss_bad=ss_bad)
    clock.append(time.perf_counter())
    cap["compared"]["seconds"] = dict(zip(("posteriors", "merges", "dd", "final"),
                                          np.diff(clock).round(2).tolist()))
    return out


def plan(cap: dict, spec: dict, rng) -> None:
    """Choose, from the seed's `rng`, the merges and DD layers of `cap`
    that the check compares."""
    layers = F.layers(cap["tree"], len(cap["records"]))
    cap["sampled_merges"] = _sample_merges(layers, spec.get("merges"), rng)
    cap["replayed_layers"] = _replay_layers(cap["layers"], spec["dd_replay_budget"])


def control_numbers(ref: F.Reference, ctrl: F.Reference, cap: dict) -> dict:
    """The control's readings: the reference computed with TF32 on (`ctrl`)
    put in the program's place at the family and the sampled merges of
    `cap`, judged as the program is.  It decodes nothing of its own: the
    merges' child alignments and the final alignment are the program's, and
    so are the structures its bp-updates ran under (both sides update under
    them; the averages before the updates count too).  The exact
    comparisons (the tree, the rows, the DD, the structure of a given
    input) take no precision and are not read."""
    seqs = [s for _, s in cap["records"]]
    recs = [F.Record(n, s) for n, s in cap["records"]]
    want, got = ref.posteriors(seqs), ctrl.posteriors(seqs)
    out = dict(bp_err=cut_err(got["bp"], want["bp"]), mp_err=cut_err(got["mp"], want["mp"]),
               sim_err=float(np.abs(got["sim"].astype(np.float64) - want["sim"]).max()))
    tree, rows = cap["tree"], cap["rows"]
    updates = _updates(cap)
    err = 0.0
    for m in sorted(cap["sampled_merges"]):
        l, r = tree[m][1]
        aln1 = F.sub_alignment(rows, F.leaves_under(tree, l))
        aln2 = F.sub_alignment(rows, F.leaves_under(tree, r))
        under = [_under(updates.get(_group(a))) for a in (aln1, aln2)]
        w, wa = ref.merge_inputs(want["bp"], want["mp"], recs, aln1, aln2, under=under)
        g, ga = ctrl.merge_inputs(got["bp"], got["mp"], recs, aln1, aln2, under=under)
        err = max(err, *(cut_err(a, b) for a, b in zip((*g, *ga), (*w, *wa))))
    aln = F.sub_alignment(rows, F.leaves_under(tree, len(tree) - 1))
    under = _under(updates.get(_group(aln)))
    g, ga = ctrl.final_p(got["bp"], recs, aln, under=under)
    w, wa = ref.final_p(want["bp"], recs, aln, under=under)
    out.update(merge_in_err=err, final_in_err=max(cut_err(g, w), cut_err(ga, wa)))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, one line per number)."""
    ok, lines = True, []
    for k in NUMBERS:
        v, lim = numbers.get(k, float("inf")), limits[k]
        good = v <= lim
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r}{'' if good else '  FAIL'}")
    return ok, lines
