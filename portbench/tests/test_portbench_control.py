"""The control on a card: the reference computed with TF32 on, put in the
program's place, fails the cell's limits, while the program passes them,
on the seeds' first families of `default-trna` (marker `cuda`; run as the
README says)."""

from __future__ import annotations

import io

import pytest

from conftest import load_bench


@pytest.mark.cuda
def test_tf32_control_fails_the_limits_the_program_passes():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only a card computes")
    from portbench import check, control, harness

    cell = harness.Cell(load_bench(), "default-trna")
    cell.checks = dict(cell.checks, families=1)
    rows = control.readings(cell, [1, 2, 3], [1, 2, 3], "cuda:0", out=io.StringIO())
    for row in rows:
        ok, lines = check.judge(row["numbers"] | {k: 0 for k in ("tree_bad", "rows_bad", "dd_bad")},
                                cell.checks["limits"])
        assert ok == (row["kind"] == "program"), (row["seed"], row["kind"], lines)
