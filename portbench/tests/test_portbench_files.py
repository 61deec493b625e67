"""Every cell, configuration, traffic mix, check and metric of
BENCHMARK.json resolves to its file by name, and the file keeps to the
benchmark's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT, load_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_bench()
PB = os.path.join(ROOT, "portbench")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    from portbench import harness

    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cell = harness.Cell(BENCH, w["name"])
    assert os.path.exists(os.path.join(PB, "traffic", f"{w['traffic']}.json"))
    from portbench import check

    assert set(cell.checks["limits"]) == set(check.NUMBERS)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in cell.metrics["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.metrics["per_layer"]
    for kind in ("end_to_end", "per_layer"):
        for m, read in cell.readers(kind):
            assert callable(read)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and len(c["source"]) <= 200
    assert c["file"].startswith("portbench/configs/")
    with open(os.path.join(ROOT, c["file"])) as fh:
        conf = json.load(fh)
    assert conf["name"] == c["name"]
    # each model has the check's reference, and the port runs it
    from dafs_tpu_torch.models import align_models, fold_models
    from portbench.reference import family

    for kind, by_name in (("fold", fold_models.by_name), ("align", align_models.by_name)):
        assert os.path.isfile(family.model_file(kind, conf[f"{kind}_model"]))
        by_name(conf[f"{kind}_model"], 0.01)
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(PB, "metrics", f"{m['name']}.py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
