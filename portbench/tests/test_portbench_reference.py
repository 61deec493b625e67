"""The reference against the port's plain CPU path on a tiny family: on the
CPU every kernel wrapper of the port runs its plain version, of which the
reference is a frozen copy, so every stage agrees bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import ROOT, TINY_FA, load_bench
from portbench import check, harness
from portbench.reference import family as F

RECORDS = [(b[0].strip(), b[1].strip()) for b in
           (blk.split("\n", 1) for blk in TINY_FA.strip().lstrip(">").split("\n>"))]


def _port(config):
    capture = harness.Capture()
    try:
        d, _ = harness._family_run(config, RECORDS, "cpu")
    finally:
        capture.close()
    layers, _, final, _ = capture.take()
    return d, layers, final


@pytest.mark.parametrize("conf", load_bench()["configs"], ids=lambda c: c["name"])
def test_reference_equals_the_plain_port(conf):
    config = harness.load_json(ROOT, conf["file"])
    d, layers, (final_p, _) = _port(config)
    ref = F.Reference(config["options"], config["fold_model"], config["align_model"], "cpu")
    seqs = [s for _, s in RECORDS]
    post = ref.posteriors(seqs)
    for k, got in (("bp", d.bp), ("mp", d.mp), ("sim", d.result["similarity"])):
        assert np.array_equal(got, post[k]), k
    assert F.Reference.tree(post["sim"]) == d.tree
    rows = d.result["rows"]
    recs = [F.Record(n, s) for n, s in RECORDS]
    sched = F.layers(d.tree, len(seqs))
    assert [len(x) for x in sched] == [len(p) for p, _, _ in layers]
    for merges, (problems, sols, stats) in zip(sched, layers):
        for m, prob in zip(merges, problems):
            l, r = d.tree[m][1]
            want, _ = ref.merge_inputs(post["bp"], post["mp"], recs,
                                       F.sub_alignment(rows, F.leaves_under(d.tree, l)),
                                       F.sub_alignment(rows, F.leaves_under(d.tree, r)))
            for g, w in zip(prob[:3], want):
                assert np.array_equal(g, w)
        for sol, st, want in zip(sols, stats, ref.replay_dd(problems)):
            assert np.float32(sol[0]) == np.float32(want[0])
            assert all(np.array_equal(a, b) for a, b in zip(sol[1:4], want[1:4]))
            assert tuple(st) == tuple(want[4:])
    p, _ = ref.final_p(post["bp"], recs,
                       F.sub_alignment(rows, F.leaves_under(d.tree, len(d.tree) - 1)))
    assert np.array_equal(p, final_p)
    assert F.brackets(ref.decode(p, 0.2)) == d.result["ss_cons"]


def test_cut_err_reads_a_cut_value_by_its_distance_from_the_cut():
    a = np.array([[0.0, 0.5], [0.0100002, 0.0]], np.float32)
    b = np.array([[0.0, 0.5001], [0.0, 0.3]], np.float32)
    assert check.cut_err(a, a) == 0.0
    assert check.cut_err(a, b) == pytest.approx(0.3 - 0.01)
    assert check.cut_err(a[:, :1], b) == float("inf")
    b[1, 1] = 0.0
    assert check.cut_err(a, b) == pytest.approx(1e-4, rel=1e-2)


def test_structure_helpers():
    assert F.brackets(np.array([6, 5, -1, -1, -1, 1, 0])) == "((...))"
    p = np.zeros((7, 7), np.float32)
    p[0, 6] = p[1, 5] = 0.9
    ref = F.Reference(dict(th_s=[0.2], th_a=0.01, w_pct_a=0.25, w_pct_s=0.25,
                           use_alifold=True), "Boltzmann", "ProbCons", "cpu")
    assert F.brackets(ref.decode(p, 0.2)) == "((...))"
    tree = [(0.0, (-1, -1))] * 3 + [(0.5, (0, 2)), (0.4, (3, 1))]
    assert F.layers(tree, 3) == [[3], [4]] and F.leaves_under(tree, 4) == [0, 2, 1]
    rows = ["AC-G", "A--G", "-CUG"]
    assert [a.mask.tolist() for a in F.sub_alignment(rows, [0, 1])] == [
        [True, True, True], [True, False, True]]
