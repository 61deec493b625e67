"""Shared fixtures of the benchmark's tests: a tiny cell on the CPU.

The cell runs the real configurations on four 24-25 nt sequences, with the
limits of `checks/default-trna.json` and copies of the benchmark's model
references (`reference/fold`, `reference/align`), through the harness with
its look for a card skipped (`harness.run_cell(..., device="cpu")`)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_FA = """>a
GGGCAACGACGUUCGUCGAAACCC
>b
GGGCAACGACGUUCGUCGAAACCCA
>c
GGCAAACGACGUUCGUCGAAAGCC
>d
GGGCAAGGACGUUCGUCCAAACCC
"""


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.fixture
def tiny_cell(tmp_path):
    """make(config, file=None) -> a `harness.Cell` named "tiny" of that
    configuration (of `file`, where it is not one of the benchmark's)."""
    from portbench import harness

    root = tmp_path / "bench"
    for d in ("traffic", "data", "checks"):
        (root / d).mkdir(parents=True)
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"), root / "metrics")
    for kind in ("fold", "align"):
        shutil.copytree(os.path.join(ROOT, "portbench", "reference", kind),
                        root / "reference" / kind, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "data" / "tiny.fa").write_text(TINY_FA)
    (root / "traffic" / "tiny.json").write_text(json.dumps(dict(
        fasta="tiny.fa", sizes=[4], pool=dict(seed=3, blocks=2),
        mutation=dict(deletion=0.01, insertion=0.01, substitution=0.08))))
    shutil.copy(os.path.join(ROOT, "portbench", "checks", "default-trna.json"),
                root / "checks" / "tiny.json")

    def make(config="dafs-default", file=None):
        bench = load_bench()
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(dict(name=config,
                                         file=file or f"portbench/configs/{config}.json"))
        bench["workloads"].append(dict(name="tiny", config=config, traffic="tiny", chips=1,
                                       why="a test"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            m.setdefault("workloads", []).append("tiny")
        return harness.Cell(bench, "tiny", root=str(root))

    make.root = str(root)
    return make
