"""The span recorder (`dafs_tpu_torch/utils/spans.py`) on small families on
the CPU: off it records nothing; on, its spans nest, carry their family's
id, give exactly the seconds of `Result.phase_seconds` and
`consensus_calls`, count the DD loop's bodies, and leave the results bit
for bit as they are with recording off.  Each case runs under one DD
update rule of the device loop, or the host loop (`dd_host`).  The CONTRA
models' spans (`contrafold.batch`, `paircrf.batch`) on a family of
`-s CONTRAfold -a CONTRAlign`: their nesting and counters."""

import json

import numpy as np
import pytest
import torch

from dafs_tpu_torch import api, cli, pipeline
from dafs_tpu_torch.fasta import Fasta
from dafs_tpu_torch.models import align_models, fold_models
from dafs_tpu_torch.ops import alifold, contrafold, paircrf
from dafs_tpu_torch.typedefs import CUTOFF
from dafs_tpu_torch.utils import spans

torch.set_num_threads(1)

# four mutated copies of one 36-nt hairpin-rich sequence
FAMILY = [
    ("a", "GGGCGCAAGCCUAGCUCAGUUGGUAGAGCGCCUGCU"),
    ("b", "GGGCGCUUGCCUAGCUCAGUGGUAGAGCGCCUGCUU"),
    ("c", "GGACGCAAGCCUAGCUCAGGUUGGUAGAGCACCUGC"),
    ("d", "GGGCGCAAGCUAGCUCAGUUGGUAAGAGCGCCUGCA"),
]
CASES = {
    "subgradient": dict(dd_update="subgradient"),
    "adagrad": dict(dd_update="adagrad"),
    "adam": dict(dd_update="adam"),
    "host": dict(dd_host=True),
}
_RUNS: dict = {}


def _dafs(case):
    return pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, CUTOFF),
                         pipeline.Options(**CASES[case]),
                         alifold_model=alifold.Alifold(0.0, bl=True), device="cpu")


def _run(case, record):
    """(result, spans or None) of one run of FAMILY, kept for the module."""
    key = (case, record)
    if key not in _RUNS:
        d = _dafs(case)
        fa = [Fasta(n, s) for n, s in FAMILY]
        if record:
            with spans.record() as recs:
                d.run(fa)
        else:
            recs = None
            d.run(fa)
        _RUNS[key] = (d.result, recs)
    return _RUNS[key]


def _under(recs, sp, name):
    """Whether `sp` lies under a span named `name`."""
    while sp.parent is not None:
        sp = recs[sp.parent]
        if sp.name == name:
            return True
    return False


def test_off_records_nothing(monkeypatch):
    entered = []
    enter = spans.Span.__enter__

    def keep(self):
        entered.append(self)
        return enter(self)

    monkeypatch.setattr(spans.Span, "__enter__", keep)
    d = _dafs("subgradient")
    d.run([Fasta(n, s) for n, s in FAMILY])
    # only the timed spans, whose seconds the results keep, read the clock
    assert entered and {sp.name for sp in entered} <= (
        set(d.result["phase_seconds"]) | {"consensus.call", "consensus.prep"})
    assert all(sp.id is None and not sp.counts for sp in entered)
    assert spans.span("x") is spans.span("y") and not spans.recording()


def test_recorder_nests_counts_and_does_not_nest_twice():
    with spans.record() as recs:
        with spans.span("a", k=1) as a:
            spans.count("n")
            with spans.span("b") as b:
                spans.count("n", 2)
                spans.count("n", 3)
        with spans.timed("c"):
            pass
        with pytest.raises(RuntimeError):
            with spans.record():
                pass
    assert [s.name for s in recs] == ["a", "b", "c"]
    assert (a.id, a.parent, a.family, a.attrs, a.counts) == (0, None, 0, {"k": 1}, {"n": 1})
    assert (b.id, b.parent, b.family, b.counts) == (1, 0, 0, {"n": 5})
    assert recs[2].family == 2 and a.t0 <= b.t0 <= b.t1 <= a.t1 <= recs[2].t0
    assert json.loads(json.dumps(a.as_dict()))["counts"] == {"n": 1}
    spans.count("n")  # off: returns at once
    assert not spans.recording()


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_in_their_family(case):
    res, recs = _run(case, True)
    roots = [sp for sp in recs if sp.parent is None]
    assert [sp.name for sp in roots] == ["family"]
    assert roots[0].attrs == {"n": len(FAMILY), "residues": sum(len(s) for _, s in FAMILY)}
    for sp in recs:
        assert sp.family == roots[0].id and sp.t0 <= sp.t1
        if sp.parent is not None:
            up = recs[sp.parent]
            assert up.t0 <= sp.t0 and sp.t1 <= up.t1, (up.name, sp.name)
    names = {sp.name for sp in recs}
    want = {"merge.inputs", "merge.project", "projection.average", "consensus.call",
            "consensus.prep", "consensus.attempt", "dd.solve", "dd.loop"}
    if case != "host":
        want |= {"merge.layer", "dd.prep", "dd.upload", "dd.check", "dd.readback"}
    assert want <= names
    for sp in recs:
        if sp.name == "dd.upload":
            assert sp.counts["h2d_bytes"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_phase_spans_give_phase_seconds(case):
    res, recs = _run(case, True)
    phases = res["phase_seconds"]
    for name, sec in phases.items():
        got = 0.0
        for sp in recs:
            if sp.name == name and not _under(recs, sp, "refinement"):
                got += sp.seconds
        assert got == sec, name
    assert {sp.name for sp in recs if sp.parent == 0} - {"merge.layer"} <= set(phases)


@pytest.mark.parametrize("case", list(CASES))
def test_consensus_spans_match_consensus_calls(case):
    res, recs = _run(case, True)
    calls = [sp for sp in recs if sp.name == "consensus.call"]
    assert len(calls) == len(res["consensus_calls"]) > 0
    for sp, c in zip(calls, res["consensus_calls"]):
        assert sp.seconds == c["seconds"]
        assert {k: sp.attrs[k] for k in ("ns", "n", "route", "attempts")} == {
            k: c[k] for k in ("ns", "n", "route", "attempts")}
        kids = [k for k in recs if k.parent == sp.id]
        if c["route"] == "alifold":
            assert sp.attrs["bcut"] == c["bcut"]
            assert [k.name for k in kids] == (
                ["consensus.prep"] + ["consensus.attempt"] * c["attempts"])
            assert kids[0].seconds == c["prep_seconds"]
        else:
            assert not kids


@pytest.mark.parametrize("case", list(CASES))
def test_dd_loop_counts_its_bodies(case):
    res, recs = _run(case, True)
    loops = [sp for sp in recs if sp.name == "dd.loop"]
    assert all(recs[sp.parent].name == "dd.solve" for sp in loops)
    if case == "host":
        assert [sp.counts["iterations"] for sp in loops] == [t for t, _ in res["host_dd"]]
        return
    ts = [t for t, _ in res["device_dd"]]
    k = 0
    for sp in loops:
        B = sp.attrs["B"]
        assert len(sp.attrs["lens"]) == B
        top = max(ts[k: k + B])
        k += B
        assert top <= sp.counts["iterations"] <= top + 7
        checks = [c for c in recs if c.parent == sp.id]
        assert checks and {c.name for c in checks} == {"dd.check"}
    assert k == len(ts)


@pytest.mark.parametrize("case", list(CASES))
def test_recording_leaves_results_bit_equal(case):
    off, _ = _run(case, False)
    on, _ = _run(case, True)
    assert on["ss_cons"] == off["ss_cons"] and on["rows"] == off["rows"]
    assert on["score"] == off["score"] and on["tree"] == off["tree"]
    assert on["device_dd"] == off["device_dd"] and on["host_dd"] == off["host_dd"]
    assert np.array_equal(on["similarity"], off["similarity"])


def test_profile_writes_spans(tmp_path, capsys):
    """`--profile DIR` writes the spans of the profiled run as spans.json."""
    fa = tmp_path / "f.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in FAMILY[:3]))
    out_dir = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--profile", str(out_dir), str(fa)]) == 0
    capsys.readouterr()
    recs = json.loads((out_dir / "spans.json").read_text())
    assert json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    assert recs[0]["name"] == "family" and recs[0]["parent"] is None
    assert {"fold", "align", "merge DD", "final decode", "dd.loop"} <= {r["name"] for r in recs}
    assert all(r["family"] == 0 and r["t0"] <= r["t1"] for r in recs)
    assert not spans.recording()


# -- the CONTRA models (`-s CONTRAfold -a CONTRAlign`) -------------------------

# three short sequences in two of CONTRAfold's 32-length buckets
CONTRA_FAMILY = [
    ("a", "GGGCAACGACGUUCGUCGAAACCC"),
    ("b", "GGGCAACGACGUUCGUCGAAACCCAGGGAAAUCCCUUU"),
    ("c", "GGCAAACGACGUUCGUCGAAAGCC"),
]
_CONTRA_RUNS: dict = {}


def _contra_run(record):
    """(result, spans or None) of one `-s CONTRAfold -a CONTRAlign` run of
    CONTRA_FAMILY, as `api.make_dafs` builds it, kept for the module."""
    if record not in _CONTRA_RUNS:
        d = api.make_dafs(pipeline.Options(), device="cpu", align_model="CONTRAlign",
                          fold_model="CONTRAfold")
        fa = [Fasta(n, s) for n, s in CONTRA_FAMILY]
        if record:
            with spans.record() as recs:
                d.run(fa)
        else:
            recs = None
            d.run(fa)
        _CONTRA_RUNS[record] = (d.result, recs)
    return _CONTRA_RUNS[record]


def _bucket(n):
    return -(-n // 32) * 32


# counters of work that only a card does: pair-CRF batches through the
# kernels, CONTRAfold buckets captured and replayed as CUDA graphs
CARD_COUNTS = ("kernel_batches", "graph_captures", "graph_replays")


def test_contra_spans_nest_under_their_phase():
    """Each CONTRAfold bucket is a `contrafold.batch` under the phase
    "fold", the pair-CRF's one batch a `paircrf.batch` under "align", each
    with its read-back under it and non-zero counters, but for the card's
    (`kernel_batches`, `graph_captures`, `graph_replays`), 0 on the CPU,
    where a bucket runs on its own B rows (`Bp`)."""
    res, recs = _contra_run(True)
    folds = [sp for sp in recs if sp.name == "contrafold.batch"]
    crfs = [sp for sp in recs if sp.name == "paircrf.batch"]
    assert sorted(sp.attrs["L"] for sp in folds) == [32, 64]
    assert sorted(sp.attrs["B"] for sp in folds) == [1, 2]
    assert len(crfs) == 1 and crfs[0].attrs["B"] == 3
    for sp, phase, readback in ([(f, "fold", "contrafold.readback") for f in folds]
                                + [(crfs[0], "align", "paircrf.readback")]):
        assert recs[sp.parent].name == phase and _under(recs, sp, "family")
        kids = [k for k in recs if k.parent == sp.id]
        assert [k.name for k in kids] == [readback]
        assert sp.t0 <= kids[0].t0 <= kids[0].t1 <= sp.t1
        assert sp.counts and all(v > 0 for k, v in sp.counts.items() if k not in CARD_COUNTS)
        assert all(sp.counts[k] == 0 for k in CARD_COUNTS if k in sp.counts)
    assert all(sp.attrs["Bp"] == sp.attrs["B"] for sp in folds)
    # the consensus of a one-sequence group folds again (Vienna's McCaskill)
    assert {c["route"] for c in res["consensus_calls"]} >= {"mccaskill"}


@pytest.mark.parametrize("pairs", [[(0, 1)], [(0, 1), (0, 2), (1, 2)]], ids=["one", "three"])
def test_paircrf_counts_diagonals_and_cells(pairs):
    """`diagonals` is the forward and the backward loop's steps,
    2 (l1max + l2max + 1) at the padded lengths; `cells` the DP cells of
    the true lengths, (len1 + 1)(len2 + 1) a pair, in 5 states."""
    s1 = [CONTRA_FAMILY[i][1] for i, _ in pairs]
    s2 = [CONTRA_FAMILY[j][1] for _, j in pairs]
    with spans.record() as recs:
        paircrf.batch_posteriors(s1, s2, 0.01, "cpu")
    (sp,) = [r for r in recs if r.name == "paircrf.batch"]
    l1max, l2max = _bucket(max(map(len, s1))), _bucket(max(map(len, s2)))
    assert sp.attrs == {"B": len(pairs), "l1max": l1max, "l2max": l2max}
    assert sp.counts == {
        "diagonals": 2 * (l1max + l2max + 1),
        "cells": 5 * sum((len(a) + 1) * (len(b) + 1) for a, b in zip(s1, s2)),
        "kernel_batches": 0}


def test_paircrf_counts_no_kernel_batch_on_the_cpu():
    """Through a whole `-s CONTRAfold -a CONTRAlign` family on the CPU:
    every `paircrf.batch` ran the plain version, `kernel_batches` 0, and
    counts `diagonals` and `cells` from its attributes and the family's
    pairs as before."""
    res, recs = _contra_run(True)
    crfs = [sp for sp in recs if sp.name == "paircrf.batch"]
    seqs = [s for _, s in CONTRA_FAMILY]
    pairs = [(a, b) for k, a in enumerate(seqs) for b in seqs[k + 1:]]
    assert crfs and all(sp.counts["kernel_batches"] == 0 for sp in crfs)
    assert sum(sp.attrs["B"] for sp in crfs) == len(pairs)
    for sp in crfs:
        assert sp.counts["diagonals"] == 2 * (sp.attrs["l1max"] + sp.attrs["l2max"] + 1)
    assert sum(sp.counts["cells"] for sp in crfs) == 5 * sum(
        (len(a) + 1) * (len(b) + 1) for a, b in pairs)


@pytest.mark.parametrize("case", ["free", "constrained", "repeated"])
def test_contrafold_counts_steps_and_cells(case):
    """One `contrafold.batch` a bucket: `steps` the inside, F5, F5-outside
    and outside loops' steps, 4 L; `cells` the triangle 1 <= i <= j <= n of
    each true length n, n (n + 1) / 2 a sequence.  On the CPU a bucket runs
    eagerly on its own rows (`Bp` = `B`): no graph is captured or replayed,
    also when the same buckets come again ("repeated")."""
    seqs = [s for _, s in CONTRA_FAMILY]
    cons = ["?" * len(s) for s in seqs] if case == "constrained" else None
    calls = 2 if case == "repeated" else 1
    with spans.record() as recs:
        for _ in range(calls):
            contrafold.batch_bp_posteriors(seqs, 0.0, "cpu", constraints=cons)
    got = [(sp.attrs, sp.counts) for sp in recs if sp.name == "contrafold.batch"]
    want = {}
    for s in seqs:
        B, c = want.get(_bucket(len(s)), (0, 0))
        want[_bucket(len(s))] = (B + 1, c + len(s) * (len(s) + 1) // 2)
    assert got == calls * [({"B": B, "Bp": B, "L": L},
                            {"steps": 4 * L, "cells": c, "graph_captures": 0, "graph_replays": 0})
                           for L, (B, c) in want.items()]


def test_contra_spans_off_record_nothing(monkeypatch):
    """With recording off the CONTRA models enter no span and count
    nothing."""
    entered = []
    enter = spans.Span.__enter__

    def keep(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(spans.Span, "__enter__", keep)
    seqs = [s for _, s in CONTRA_FAMILY]
    contrafold.batch_bp_posteriors(seqs, 0.0, "cpu")
    paircrf.batch_posteriors(seqs[:2], seqs[1:], 0.01, "cpu")
    assert entered == [] and not spans.recording()


@pytest.mark.parametrize("case", ["family", "buckets", "constrained buckets"])
def test_contra_recording_leaves_results_bit_equal(case):
    """Recording on or off: the same family result, or the same CONTRAfold
    posteriors of CONTRA_FAMILY's two buckets (free or constrained)."""
    if case != "family":
        seqs = [s for _, s in CONTRA_FAMILY]
        cons = ["(" + "?" * (len(s) - 2) + ")" for s in seqs] if case.startswith("con") else None
        off = contrafold.batch_bp_posteriors(seqs, 0.0, "cpu", constraints=cons)
        with spans.record():
            on = contrafold.batch_bp_posteriors(seqs, 0.0, "cpu", constraints=cons)
        assert all(np.array_equal(a, b) for a, b in zip(on, off)) and len(on) == len(seqs)
        return
    off, _ = _contra_run(False)
    on, _ = _contra_run(True)
    assert on["ss_cons"] == off["ss_cons"] and on["rows"] == off["rows"]
    assert on["score"] == off["score"] and on["tree"] == off["tree"]
    assert on["device_dd"] == off["device_dd"]
    assert np.array_equal(on["similarity"], off["similarity"])
