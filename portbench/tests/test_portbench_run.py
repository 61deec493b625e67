"""A run on the CPU, the harness's look for a card skipped: sound, its
`correct` is true and the readers read it; with the timed path broken
underneath, `correct` comes out false."""

from __future__ import annotations

import time

import numpy as np
import pytest

from conftest import load_bench
from portbench import harness


def _run(cell, seed=2**31 + 11, seconds=0.1):
    line, lines = harness.run_cell(cell, seed, seconds, False, "cpu", time.perf_counter())
    return line, "\n".join(lines)


@pytest.mark.parametrize("config", [c["name"] for c in load_bench()["configs"]])
def test_sound_run_is_correct(tiny_cell, config):
    line, lines = _run(tiny_cell(config))
    assert line["correct"], lines
    # the window is whole passes of the tiny mix's pool of two
    assert line["attempted"] in (2, 4) and line["failed"] == 0
    assert list(line)[-1] == "checks"
    m = line["metrics"]
    assert set(m) == {"family_s", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())


def test_pct_that_returns_its_state_unchanged_fails(tiny_cell, monkeypatch):
    from dafs_tpu_torch import consistency

    monkeypatch.setattr(consistency, "relax_matching_probability",
                        lambda mp, *a, **k: mp.copy())
    line, lines = _run(tiny_cell())
    assert not line["correct"], lines
    assert line["checks"]["mp_err"]["value"] > line["checks"]["mp_err"]["limit"]


def test_half_the_group_averaged_fails(tiny_cell, monkeypatch):
    from dafs_tpu_torch import projection

    orig = projection.average_basepairing_probability

    def half(bp, aln, alifold_bp=None):
        return orig(bp, aln[: -(-len(aln) // 2)], alifold_bp)

    monkeypatch.setattr(projection, "average_basepairing_probability", half)
    line, lines = _run(tiny_cell())
    assert not line["correct"], lines
    assert line["checks"]["merge_in_err"]["value"] > line["checks"]["merge_in_err"]["limit"]


def test_final_structure_altered_where_decoded_fails(tiny_cell, monkeypatch):
    from dafs_tpu_torch import pipeline

    orig = pipeline.Dafs._decode_structure

    def drop_a_pair(self, p, th_list):
        ss, s = orig(self, p, th_list)
        i = s.find("(")
        if i >= 0:
            j = int(ss[i])
            s = s[:i] + "." + s[i + 1: j] + "." + s[j + 1:]
        return ss, s

    monkeypatch.setattr(pipeline.Dafs, "_decode_structure", drop_a_pair)
    line, lines = _run(tiny_cell())
    assert not line["correct"], lines
    assert line["checks"]["ss_bad"]["value"] == 1


def test_dd_that_returns_its_state_unchanged_fails(tiny_cell, monkeypatch):
    """A DD step that leaves the multipliers where they were (a step width
    of 0): every merge runs to the iteration cap on its first decodes."""
    from dafs_tpu_torch import dd

    orig = dd._dd_core
    monkeypatch.setattr(dd, "_dd_core", lambda pr, **kw: orig(pr, **{**kw, "eta0": 0.0}))
    line, lines = _run(tiny_cell())
    assert not line["correct"], lines
    assert line["checks"]["dd_bad"]["value"] > 0


def test_readers_on_a_cpu_run(tiny_cell, monkeypatch):
    """The per-layer readers on a CPU run's families; the trace's readers
    on a made-up trace of two decodes."""
    runs = []

    class Keep(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Keep)
    cell = tiny_cell()
    line, _ = _run(cell, seconds=1.0)
    assert line["correct"]
    run = runs[0]
    fams = run.families
    read = {m["name"]: r for m, r in cell.readers("per_layer")}
    for name, phases in (("fold_s", ["fold"]), ("align_s", ["align"]),
                         ("pct_s", ["similarity", "PCT"]), ("merge_dd_s", ["merge DD"]),
                         ("consensus_s", ["merge avg+alifold", "final avg_bp (+alifold)"])):
        want = np.mean([sum(f.phase_seconds[k] for k in phases) for f in fams])
        assert read[name](run) == pytest.approx(want) and want > 0
    prep = [c["prep_seconds"] for f in fams for c in f.consensus_calls if "prep_seconds" in c]
    assert read["consensus_prep_s"](run) == pytest.approx(sum(prep) / len(fams))
    iters = sum(t for f in fams for t, _ in f.device_dd)
    assert read["dd_iters_per_s"](run) == pytest.approx(
        iters / sum(f.phase_seconds["merge DD"] for f in fams))
    for name in ("decode_roofline_pct", "device_idle_pct", "peak_mem_gib"):
        assert read[name](run) is None
    e2e = {m["name"]: r for m, r in cell.readers("end_to_end")}
    assert e2e["family_s"](run) == pytest.approx(run.window_s / len(fams))
    assert e2e["setup_s"](run) == run.setup_s
    # 2 us of operations and 1 us of bytes at the peaks, in 8 us of device time
    run.trace = harness.Trace(busy_s=0.25, window_s=1.0, device_ops=[], idle_gaps=[],
                              decodes=[("nussinov", 2.0 * 67e12 * 1e-6, 0.0, 4e-6),
                                       ("nw", 0.0, 3.35e12 * 1e-6, 4e-6)])
    assert read["decode_roofline_pct"](run) == pytest.approx(37.5)
    assert read["device_idle_pct"](run) == pytest.approx(75.0)
    run.peak_window_bytes = 3 * 2**29
    assert read["peak_mem_gib"](run) == pytest.approx(1.5)
