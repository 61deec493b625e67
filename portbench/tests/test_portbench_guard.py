"""Nothing that a run of the benchmark runs imports JAX or the JAX package:
in a subprocess, a meta-path finder refuses every module whose top-level
name is exactly `jax` or `dafs_tpu` (so `dafs_tpu_torch` passes); under it
the entry, every metric reader, the reference with every model file and
the control are imported, and a tiny cell runs on the CPU."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from conftest import ROOT

PROGRAM = textwrap.dedent("""
    import importlib, importlib.abc, json, os, sys, time

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "dafs_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {root!r})
    import portbench.run, portbench.control, portbench.check, portbench.trace
    from portbench.reference import family
    for name in os.listdir(os.path.join({root!r}, "portbench", "reference")):
        if name.endswith(".py") and name != "__init__.py":
            importlib.import_module("portbench.reference." + name[:-3])
    for kind in ("fold", "align"):
        for name in os.listdir(os.path.join({root!r}, "portbench", "reference", kind)):
            if name.endswith(".py"):
                family.load_model(kind, name[:-3])
    from portbench import harness
    bench = harness.load_json({root!r}, "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        harness.load_reader(m["name"])
        m.setdefault("workloads", []).append("tiny")
    bench["workloads"].append(dict(name="tiny", config="dafs-default", traffic="tiny",
                                   chips=1, why="a test"))
    cell = harness.Cell(bench, "tiny", root={tiny!r})
    line, _ = harness.run_cell(cell, 5, 0.1, False, "cpu", time.perf_counter())
    found = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "dafs_tpu"}})
    print(json.dumps(dict(correct=line["correct"], found=found)))
""")


def test_no_jax_under_a_refusing_finder(tiny_cell):
    tiny_cell()
    out = subprocess.run([sys.executable, "-c", PROGRAM.format(root=ROOT, tiny=tiny_cell.root)],
                         capture_output=True, text=True, timeout=600,
                         env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "found": []}
