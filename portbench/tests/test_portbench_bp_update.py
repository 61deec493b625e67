"""The check under bp-update (`--bp-update --bp-update1`) on the tiny cell:
a configuration `dafs-bpupdate` made for the tests (`dafs-default`'s options
with `use_bp_update` and `use_bp_update1` on) and the limits of
`checks/default-trna.json`.  The reference's bp-update against the port's
bit for bit; a sound run `correct`; the program's update skipped, run
unconstrained or run under an altered structure, the check fails.  And
the options the check cannot follow stop a cell when it is loaded, and no
benchmark configuration makes a bp-update."""

from __future__ import annotations

import io
import json
import time

import numpy as np
import pytest

from conftest import ROOT, TINY_FA, load_bench
from portbench import harness
from portbench.reference import family as F
from portbench.reference import projection

RECORDS = [(b[0].strip(), b[1].strip()) for b in
           (blk.split("\n", 1) for blk in TINY_FA.strip().lstrip(">").split("\n>"))]


def _config(**options):
    config = harness.load_json(ROOT, "portbench", "configs", "dafs-default.json")
    config["name"] = "dafs-bpupdate"
    config["options"].update(options)
    return config


def _write(tmp_path, config):
    path = tmp_path / f"{config['name']}.json"
    path.write_text(json.dumps(config))
    return str(path)


def _bp_cell(tiny_cell, tmp_path, **options):
    config = _config(use_bp_update=True, use_bp_update1=True, **options)
    return tiny_cell(config["name"], _write(tmp_path, config))


def _run(cell, seed=2**31 + 77):
    log = io.StringIO()
    line, lines = harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter(), log=log)
    return line, "\n".join([log.getvalue(), *lines])


# -- (a) the reference's update against the port's -------------------------

# two groups of the tiny family: three rows with gaps, one sequence alone
GROUPS = {"three": ([0, 1, 2], ["GGGCAACGACGUUCGUCGAAACCC-", "GGGCAACGACGUUCGUCGAAACCCA",
                                 "GG-CAAACGACGUUCGUCGAAAGCC"]),
          "one": ([3], ["GGGCAAGGACGUUCGUCCAAACCC"])}


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("use_alifold", [True, False], ids=["consensus", "no-consensus"])
@pytest.mark.parametrize("th_s", [(0.2,), (0.2, 0.111)], ids=["one-level", "two-levels"])
def test_reference_update_equals_the_port(th_s, use_alifold, group):
    """`Reference.update_bp` gives the bits of `Dafs._update_bp` on the same
    input, structure and group, each side with a fresh consensus object."""
    from dafs_tpu_torch import api, pipeline
    from dafs_tpu_torch.fasta import Fasta

    opts = dict(th_s=list(th_s), use_alifold=use_alifold, use_bp_update=True)
    d = api.make_dafs(pipeline.Options(**(opts | {"th_s": th_s})), device="cpu")
    d.fa = [Fasta(n, s) for n, s in RECORDS]
    ref = F.Reference(_config(**opts)["options"], "Boltzmann", "ProbCons", "cpu")
    recs = [F.Record(n, s) for n, s in RECORDS]
    ids, rows = GROUPS[group]
    aln = [F.AlnRow(i, np.array([c != "-" for c in r])) for i, r in zip(ids, rows)]
    bp = ref.posteriors([s for _, s in RECORDS])["bp"]
    p = projection.average_basepairing_probability(bp, aln, None)
    ss = ref.decode(p, th_s[0])
    assert (ss >= 0).any(), "the structure has no pair: the update would constrain nothing"
    sstr = F.brackets(ss)
    got = d._update_bp(p, ss, sstr, aln, use_alifold)
    want = ref.update_bp(p, ss, sstr, aln, recs, use_alifold)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # the update moves the input: it is no average passed through
    assert not np.array_equal(got, p)


# -- (b) a sound run ----------------------------------------------------------

def test_bp_update_cell_is_correct(tiny_cell, tmp_path):
    line, out = _run(_bp_cell(tiny_cell, tmp_path))
    assert line["correct"], out
    checks = line["checks"]
    assert checks["ss_bad"]["value"] == 0, out
    for k in ("merge_in_err", "final_in_err"):
        assert checks[k]["value"] <= checks[k]["limit"], out
    # every sampled merge's two sides and the final input were compared
    assert "bp-updates compared 0" not in out, out


# -- (c) broken programs ------------------------------------------------------

def _returns_its_input(monkeypatch):
    from dafs_tpu_torch import pipeline

    monkeypatch.setattr(pipeline.Dafs, "_update_bp", lambda self, p, *a, **k: p)


def _unconstrained(monkeypatch):
    from dafs_tpu_torch import pipeline

    orig = pipeline.Dafs._update_bp

    def update(self, p, ss, sstr, aln, use_alifold):
        return orig(self, p, np.full_like(ss, -1), "." * len(sstr), aln, use_alifold)

    monkeypatch.setattr(pipeline.Dafs, "_update_bp", update)


def _one_pair_changed(monkeypatch):
    """The merges' decode before the update loses its outermost pair (or
    gains one where it has none); the final decodes are left as they are."""
    from dafs_tpu_torch import pipeline

    decode, merge_inputs = pipeline.Dafs._decode_structure, pipeline.Dafs._merge_inputs
    state = dict(in_merge=False)

    def altered(self, p, th_list):
        ss, sstr = decode(self, p, th_list)
        if not state["in_merge"]:
            return ss, sstr
        ss = ss.copy()
        pairs = F.pairs_of(ss)
        i, j = pairs[0] if pairs else (0, len(ss) - 1)
        ss[i], ss[j] = (-1, -1) if pairs else (j, i)
        return ss, F.brackets(ss)

    def in_merge(self, *a):
        state["in_merge"] = True
        try:
            return merge_inputs(self, *a)
        finally:
            state["in_merge"] = False

    monkeypatch.setattr(pipeline.Dafs, "_decode_structure", altered)
    monkeypatch.setattr(pipeline.Dafs, "_merge_inputs", in_merge)


@pytest.mark.parametrize("fault, number", [
    (_returns_its_input, "merge_in_err"),
    (_unconstrained, "merge_in_err"),
    (_one_pair_changed, "ss_bad"),
], ids=["returns-its-input", "unconstrained", "one-pair-changed"])
def test_broken_bp_update_fails(tiny_cell, tmp_path, monkeypatch, fault, number):
    cell = _bp_cell(tiny_cell, tmp_path)
    fault(monkeypatch)
    line, out = _run(cell)
    assert not line["correct"], out
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], out


# -- (d) what the check cannot follow stops at load ---------------------------

@pytest.mark.parametrize("options, fold_model, named", [
    (dict(fold_decoder="IPknot"), "Boltzmann", "fold_decoder"),
    (dict(n_refinement=2), "Boltzmann", "n_refinement"),
    (dict(w_pct_f=0.5), "Boltzmann", "w_pct_f"),
    (dict(dd_host=True), "Boltzmann", "dd_host"),
    (dict(verbose=2), "Boltzmann", "verbose"),
    (dict(t_max=0), "Boltzmann", "t_max"),
    (dict(use_bp_update=True), "CONTRAfold", "constrained_posteriors"),
    (dict(use_bp_update1=True), "CONTRAfold", "use_bp_update1"),
], ids=["ipknot", "refinement", "fourway", "dd-host", "verbose-2", "ilp", "bp-update-contrafold",
        "bp-update1-contrafold"])
def test_unfollowed_option_stops_at_load(tiny_cell, tmp_path, options, fold_model, named):
    config = _config(**options)
    config["name"] = "unfollowed"
    config["fold_model"] = fold_model
    with pytest.raises(SystemExit, match=named):
        tiny_cell(config["name"], _write(tmp_path, config))


def test_followed_options_load(tiny_cell, tmp_path):
    """bp-update under McCaskill, another update rule, no consensus: loaded."""
    config = _config(use_bp_update=True, use_bp_update1=True, use_alifold=False,
                     dd_update="adam", th_s=[0.2, 0.111])
    assert tiny_cell(config["name"], _write(tmp_path, config)).config == config


# -- (e) the benchmark's configurations make no update ------------------------

@pytest.mark.parametrize("conf", load_bench()["configs"], ids=lambda c: c["name"])
def test_benchmark_configs_capture_no_update(conf):
    config = harness.load_json(ROOT, conf["file"])
    assert not harness.unfollowed(config)
    capture = harness.Capture()
    try:
        d, _ = harness._family_run(config, RECORDS, "cpu")
    finally:
        capture.close()
    layers, _, final, updates = capture.take()
    assert layers and final is not None and d.result["ss_cons"]
    assert updates == []


def test_capture_keeps_each_update(tiny_cell, tmp_path):
    """Under bp-update the capture keeps one update a merge side and one
    for the final input, by reference: the update's output is the DD's
    input or the final decode's."""
    config = _config(use_bp_update=True, use_bp_update1=True)
    capture = harness.Capture()
    try:
        d, _ = harness._family_run(config, RECORDS, "cpu")
    finally:
        capture.close()
    layers, _, final, updates = capture.take()
    merges = sum(len(p) for p, _, _ in layers)
    assert len(updates) == 2 * merges + 1
    assert updates[-1]["out"] is final[0]
    dd_inputs = [x for problems, _, _ in layers for prob in problems for x in prob[:2]]
    assert all(any(u["out"] is x for u in updates[:-1]) for x in dd_inputs)
