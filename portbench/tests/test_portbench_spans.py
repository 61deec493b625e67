"""The readers of the program's spans (`spans.py`, `metrics/dd_*.py`,
`metrics/merge_avg_s.py`) on a made-up run, the span runner
(`span_run.py`) on a CPU run of the tiny cell, an untraced run that never
starts the recorder, and (marker `cuda`) the profiler's device intervals
and the program's spans on one clock."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness, span_run, spans

# (name, parent, t0, t1, counts): one family of the window, then the
# warm-up's family (before the window, left out)
WINDOW = [
    ("family", None, 1.0, 9.0, {}),
    ("merge DD", 0, 2.0, 6.0, {}),
    ("dd.solve", 1, 2.0, 6.0, {}),
    ("dd.prep", 2, 2.0, 2.5, {}),
    ("dd.upload", 2, 2.5, 2.75, {"h2d_bytes": 100}),
    ("dd.loop", 2, 2.75, 5.5, {"iterations": 10}),
    ("dd.check", 5, 3.0, 3.25, {}),
    ("dd.check", 5, 5.0, 5.25, {}),
    ("dd.readback", 2, 5.5, 6.0, {}),
    ("projection.average", 0, 6.5, 7.0, {}),
    ("projection.average", 0, 7.0, 7.25, {}),
]
WARM = [
    ("family", None, -5.0, -1.0, {}),
    ("dd.solve", 11, -4.0, -2.0, {}),
    ("dd.loop", 12, -4.0, -2.0, {"iterations": 1000}),
]
DEVICE = [("k3", 3.1, 3.2), ("k4", 4.0, 4.5), ("Memcpy HtoD (Pageable -> Device)", 2.6, 2.7),
          ("readback_kernel", 5.6, 5.7), ("after", 6.6, 6.7), ("warm", -3.0, -2.9)]


def _spans(rows):
    recs = []
    for name, parent, t0, t1, counts in rows:
        family = len(recs) if parent is None else recs[parent].family
        recs.append(SimpleNamespace(id=len(recs), parent=parent, family=family, name=name,
                                    t0=t0, t1=t1, attrs={}, counts=dict(counts)))
    return recs


def _run(with_spans=True, with_device=True):
    fam = harness.Family(n=4, residues=300, pool_index=0, start=0.5, run_start=0.6, end=9.5,
                         phase_seconds={"merge DD": 4.0}, device_dd=[], consensus_calls=[],
                         dd_spans=[])
    run = harness.Run(setup_s=1.0, window_s=9.0, families=[fam], peak_window_bytes=None,
                      trace=harness.Trace(busy_s=1.0, window_s=9.0, decodes=[], device_ops=[],
                                          idle_gaps=[]))
    if with_spans:
        run.spans = _spans(WINDOW + WARM)
    if with_device:
        run.trace.device_spans = [(s, e, n) for n, s, e in DEVICE]
    return run


def _read(name):
    return harness.load_reader(name)


def test_readers_on_a_made_up_run():
    run = _run()
    # k3, k4 and the readback's kernel start in dd.solve; the copy is no kernel
    assert _read("dd_kernels_per_iter")(run) == pytest.approx(3 / 10)
    # 2.75 s of loop less 0.5 s of done checks, over 10 bodies
    assert _read("dd_host_ms_per_iter")(run) == pytest.approx(225.0)
    # 0.1 + 0.5 + 0.1 (the copy) + 0.1 s busy of dd.solve's 4 s
    assert _read("dd_busy_pct")(run) == pytest.approx(20.0)
    assert _read("dd_prep_s")(run) == pytest.approx(0.5 + 0.25 + 0.5)
    assert _read("merge_avg_s")(run) == pytest.approx(0.75)


@pytest.mark.parametrize("name", ["dd_kernels_per_iter", "dd_host_ms_per_iter", "dd_busy_pct",
                                  "dd_prep_s", "merge_avg_s"])
def test_readers_read_nothing_without_spans(name):
    """A run that did not record spans (a harness or a program without
    them) gives no value; the device readers need the device's too."""
    assert _read(name)(_run(with_spans=False)) is None
    assert _read(name)(harness.Run(1.0, 9.0, [], None)) is None
    if name in ("dd_kernels_per_iter", "dd_busy_pct"):
        assert _read(name)(_run(with_device=False)) is None


def test_idle_by_span_takes_the_innermost_span():
    recs = spans.window_spans(_run())
    gaps = [(3.2, 4.0), (6.1, 6.6), (9.2, 9.4)]
    got = spans.idle_by_span(gaps, recs)
    assert list(got) == ["dd.loop", "family", "between families", "projection.average",
                         "dd.check"]
    assert list(got.values()) == pytest.approx([0.75, 0.4, 0.2, 0.1, 0.05])


def test_span_checks_hold_spans_to_the_harness():
    run = _run()
    line = {"breakdown": {"idle_gaps": [["merge DD", 3.2]]}}
    got = span_run.span_checks(run, line)
    assert got["families"] == got["roots_inside"] == 1
    assert got["dd_solve_over_merge_dd"] == pytest.approx(1.0)
    assert got["dd_solve_idle_over_breakdown_merge_dd"] == pytest.approx(1.0)


def test_untraced_run_keeps_its_line_and_never_records(tiny_cell, monkeypatch):
    from dafs_tpu_torch import pipeline
    from dafs_tpu_torch.utils import spans as program_spans

    seen = []
    orig = pipeline.Dafs.run

    def run(self, fa):
        seen.append(program_spans.recording())
        return orig(self, fa)

    monkeypatch.setattr(pipeline.Dafs, "run", run)
    line, _ = harness.run_cell(tiny_cell(), 2**31 + 5, 0.1, False, "cpu", time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"family_s", "setup_s"} and line["correct"]
    assert seen and not any(seen)


def test_span_runner_on_the_cpu(tiny_cell):
    """The runner's spans reach the readers; on the CPU the harness takes
    no device trace, so the device readers read nothing."""
    bench_cell = tiny_cell()
    bench_cell.metrics["per_layer"] += [dict(m, workloads=["tiny"]) for m in span_run.SPAN_METRICS]
    line, lines = span_run.run_with_spans(bench_cell, 2**31 + 7, 0.1, True, "cpu",
                                          time.perf_counter())
    assert line["correct"]
    m = line["metrics"]
    assert m["dd_host_ms_per_iter"]["value"] > 0 and m["dd_prep_s"]["value"] > 0
    assert m["merge_avg_s"]["value"] > 0
    assert "dd_kernels_per_iter" not in m and "dd_busy_pct" not in m
    checks = json.loads(lines[-1].split(": ", 1)[1])
    assert checks["families"] == checks["roots_inside"] > 0
    assert checks["dd_solve_over_merge_dd"] == pytest.approx(1.0, rel=0.01)
    assert harness.Run.__name__ == "Run"


@pytest.mark.cuda
def test_device_interval_lands_in_its_span():
    """Kernels synchronised inside spans lie inside them on the shared
    clock, within 200 us.  `DeviceTrace` reads the host clock just before
    its anchor kernel's launch, so a device interval reads early by that
    launch's latency less the kernel's own: from 117 us early to 32 us
    late on an H100 (39 kernels in 13 runs), more than the 50 us once
    asked of it.  The anchor's kernel has run before, as the harness's
    warm family runs it: a kernel's first launch loads its module, which
    put every interval 8 ms early."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dafs_tpu_torch.utils import spans as program_spans
    from portbench.trace import DeviceTrace

    torch.empty(1, device="cuda").fill_(0.0)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with program_spans.record() as recs:
        with DeviceTrace() as tr:
            for _ in range(3):
                time.sleep(0.002)
                with program_spans.span("sleep"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
    # the three sleeps, about a millisecond each; the anchor kernel takes microseconds
    sleeps = sorted((s, e) for s, e, _ in tr.spans if e - s > 200e-6)
    assert len(sleeps) == len(recs) == 3, [(n, e - s) for s, e, n in tr.spans]
    # (start less the span's start, the span's end less the end) of each
    edges = [(s - sp.t0, sp.t1 - e) for (s, e), sp in zip(sleeps, recs)]
    print("sleep edges, s:", edges)
    assert all(a >= -200e-6 and b >= -200e-6 for a, b in edges), edges


def test_dd_spans_give_the_decodes_work():
    """The DD spans' host ints (`dd.loop`'s B, P1, P2 and lens, `dd.prep`'s
    nw_cells) give `roofline.py` the K3 and K4 work of one body without
    a device read."""
    import numpy as np

    from dafs_tpu_torch import dd
    from dafs_tpu_torch.utils import spans as program_spans
    from portbench import roofline

    rng = np.random.default_rng(5)
    probs = []
    for L1, L2 in ((40, 45), (52, 33)):
        px, py = (np.triu(rng.random((n, n)), 1).astype(np.float32) * 0.6 for n in (L1, L2))
        pz = (rng.random((L1, L2)) * 0.3).astype(np.float32)
        probs.append((px, py, pz, 2, 3))
    kw = dict(w=4.0, th_s=[0.2], th_a=0.01)
    with program_spans.record() as recs:
        dd.solve_by_dd_batch(probs, eta0=0.5, t_max=3, device="cpu", **kw)
    prep, loop = (next(sp for sp in recs if sp.name == n) for n in ("dd.prep", "dd.loop"))
    pr = dd.prep_batch(probs, device="cpu", **kw)
    assert (loop.attrs["B"], loop.attrs["P1"], loop.attrs["P2"]) == tuple(pr["p_z"].shape)
    assert loop.attrs["lens"] == [[40, 45], [52, 33]]
    ops, _ = roofline.nw_work(pr["env_first"].numpy(), pr["env_last"].numpy(),
                              pr["l1"].numpy(), loop.attrs["P1"])
    assert 5 * sum(prep.attrs["nw_cells"]) == ops
    lens = [n for pair in loop.attrs["lens"] for n in pair]
    assert roofline.nussinov_work(np.array(lens), max(prep.attrs["P1"], prep.attrs["P2"]))[0] > 0
