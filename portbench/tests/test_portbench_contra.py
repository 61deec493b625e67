"""The CONTRAfold + CONTRAlign configuration (`dafs-contra`) on the tiny
cell with its real reference files (`reference/fold/CONTRAfold.py`,
`reference/align/CONTRAlign.py`) and the limits of `checks/contra-trna.json`:
sound, every number reads 0; the program's CONTRA models altered or
computed more coarsely where they are produced, the check fails, so its
limits of 0 on `bp_err` and `mp_err` catch a coarser computation.  And the
pair-CRF's span readers (`metrics/crf_*.py`) on a made-up run."""

from __future__ import annotations

import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import harness


def _contra_cell(tiny_cell):
    shutil.copy(os.path.join(ROOT, "portbench", "checks", "contra-trna.json"),
                os.path.join(tiny_cell.root, "checks", "tiny.json"))
    return tiny_cell("dafs-contra")


def _run(cell, seed=2**31 + 41):
    line, lines = harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter())
    return line, "\n".join(lines)


def test_contra_cell_reads_every_number_0(tiny_cell):
    line, lines = _run(_contra_cell(tiny_cell))
    assert line["correct"], lines
    assert all(v["value"] == 0 for v in line["checks"].values()), lines


def _scaled(cls, method):
    orig = getattr(cls, method)

    def scaled(self, *a, **k):
        return [p * np.float32(0.9) for p in orig(self, *a, **k)]

    return scaled


@pytest.mark.parametrize("kind", ["fold", "align"])
def test_contra_model_altered_fails(tiny_cell, monkeypatch, kind):
    """The program's CONTRAfold (CONTRAlign) posteriors scaled by 0.9 where
    they are produced: `bp_err` (`mp_err`) over its limit."""
    from dafs_tpu_torch.models import align_models, fold_models

    cls, method, number = {
        "fold": (fold_models.CONTRAfold, "batch_bp_posteriors", "bp_err"),
        "align": (align_models.CONTRAlign, "batch_pair_posteriors", "mp_err")}[kind]
    monkeypatch.setattr(cls, method, _scaled(cls, method))
    line, lines = _run(_contra_cell(tiny_cell))
    assert not line["correct"], lines
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], lines


def _bf16(tables, names):
    def coarse(device):
        return {k: v.to(torch.bfloat16).float() if k in names else v
                for k, v in tables(device).items()}
    return coarse


def _coarse(monkeypatch, how):
    from dafs_tpu_torch.ops import contrafold, paircrf

    if how == "crf_bf16_emissions":
        monkeypatch.setattr(paircrf, "tables", _bf16(paircrf.tables, ("match", "ins")))
        return "mp_err"
    if how == "crf_exact_exp":
        monkeypatch.setattr(paircrf, "contra_fast_exp", torch.exp)
        return "mp_err"
    monkeypatch.setattr(contrafold, "tables", _bf16(contrafold.tables, ("base_pair",
                                                                       "helix_stacking")))
    return "bp_err"


@pytest.mark.parametrize("how", ["crf_bf16_emissions", "crf_exact_exp", "fold_bf16_scores"])
def test_coarser_contra_model_fails(tiny_cell, monkeypatch, how):
    """The pair-CRF's emission tables rounded to bfloat16, or its Fast_Exp
    replaced by the exact `torch.exp`, or CONTRAfold's pair and stacking
    scores rounded to bfloat16: the posteriors move off the reference's,
    past the limit of 0."""
    number = _coarse(monkeypatch, how)
    line, lines = _run(_contra_cell(tiny_cell))
    assert not line["correct"], lines
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], lines


# -- the pair-CRF's span readers -------------------------------------------

# (name, parent, t0, t1, counts): a window family's pair-CRF batch, then the
# warm-up family's (before the window, left out)
SPANS = [
    ("family", None, 1.0, 9.0, {}),
    ("align", 0, 2.0, 6.0, {}),
    ("paircrf.batch", 1, 2.0, 6.0, {"diagonals": 10, "cells": 500}),
    ("paircrf.readback", 2, 5.0, 6.0, {}),
    ("family", None, -5.0, -1.0, {}),
    ("paircrf.batch", 4, -4.0, -2.0, {"diagonals": 1000, "cells": 5}),
]
DEVICE = [("k", 2.1, 2.2), ("k", 3.0, 3.5), ("Memcpy DtoH (Device -> Pageable)", 5.5, 5.6),
          ("k", 6.5, 6.6), ("k", -3.0, -2.9)]


def _made_up_run(with_spans=True, with_device=True):
    fam = harness.Family(n=4, residues=300, pool_index=0, start=0.5, run_start=0.6, end=9.5,
                         phase_seconds={"align": 4.0}, device_dd=[], consensus_calls=[],
                         dd_spans=[])
    run = harness.Run(setup_s=1.0, window_s=9.0, families=[fam], peak_window_bytes=None,
                      trace=harness.Trace(busy_s=1.0, window_s=9.0, decodes=[], device_ops=[],
                                          idle_gaps=[]))
    if with_spans:
        recs = []
        for name, parent, t0, t1, counts in SPANS:
            family = len(recs) if parent is None else recs[parent].family
            recs.append(SimpleNamespace(id=len(recs), parent=parent, family=family, name=name,
                                        t0=t0, t1=t1, attrs={}, counts=dict(counts)))
        run.spans = recs
    if with_device:
        run.trace.device_spans = [(s, e, n) for n, s, e in DEVICE]
    return run


def test_crf_readers_on_a_made_up_run():
    run = _made_up_run()
    # two kernels start inside the window's batch (the copy is no kernel),
    # over its 10 diagonals
    assert harness.load_reader("crf_kernels_per_diag")(run) == pytest.approx(2 / 10)
    # 0.1 + 0.5 + 0.1 (the copy) s busy of the batch's 4 s
    assert harness.load_reader("crf_busy_pct")(run) == pytest.approx(17.5)


@pytest.mark.parametrize("name", ["crf_kernels_per_diag", "crf_busy_pct"])
def test_crf_readers_read_nothing_without_spans(name):
    """A run without the program's spans (a harness or a program without
    them), or without the device's, gives no value."""
    read = harness.load_reader(name)
    assert read(_made_up_run(with_spans=False)) is None
    assert read(_made_up_run(with_device=False)) is None
    assert read(harness.Run(1.0, 9.0, [], None)) is None
