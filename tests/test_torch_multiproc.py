"""`dafs_tpu_torch.parallel.multiproc` on the CPU: several processes under
`torch.distributed` with gloo collectives, the all-pairs and PCT stages
split over them and gathered, bit-equal to one process's unsharded run.

Each run starts fresh interpreters, so every case has a subprocess
timeout.  Families are records of tests/data/RF00005_0.fa.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from dafs_tpu_torch.parallel import multiproc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF00005 = os.path.join(ROOT, "tests", "data", "RF00005_0.fa")
FLAGS = ("bitwise_equal_pairhmm", "bitwise_equal_pct_mp", "bitwise_equal_pct_bp")


def _run(tmp_path, nprocs, local, fasta, timeout):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dafs_tpu_torch.parallel.multiproc", "--device", "cpu",
         "--nprocs", str(nprocs), "--local-devices", str(local), "--fasta", fasta,
         "--timeout", str(timeout - 30)],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=timeout)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and report["ok"], report
    return report


@pytest.fixture
def six_fa(tmp_path):
    """The first six tRNAs of RF00005 (15 pairs)."""
    with open(RF00005) as fh:
        lines = fh.read().splitlines()
    path = tmp_path / "six.fa"
    path.write_text("\n".join(lines[:12]) + "\n")
    return str(path)


def test_two_processes_under_gloo(tmp_path, six_fa):
    report = _run(tmp_path, 2, 1, six_fa, timeout=240)
    assert all(report[k] for k in FLAGS)
    assert report["processes"] == 2 and report["global_devices"] == 2
    assert report["collectives"] == "gloo" and report["pairs"] == 15
    assert report["rcs"] == [0, 0]


@pytest.mark.slow
def test_rf00005_four_processes_two_shards_each(tmp_path):
    report = _run(tmp_path, 4, 2, RF00005, timeout=600)
    assert all(report[k] for k in FLAGS)
    assert report["global_devices"] == 8 and report["pairs"] == 45


def test_a_failing_child_fails_the_run(tmp_path):
    """A child that cannot read its family exits non-zero; the parent
    reports ok false with the children's logs, and exits 1."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dafs_tpu_torch.parallel.multiproc", "--device", "cpu",
         "--nprocs", "2", "--fasta", str(tmp_path / "absent.fa"), "--timeout", "120"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=180)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 1 and not report["ok"]
    assert all(rc != 0 for rc in report["rcs"]) and "absent.fa" in report["logs"][0]


@pytest.mark.parametrize("device,cards,nprocs,local,want", [
    ("cpu", 0, 2, 3, (["cpu"] * 3, "gloo", "cpu")),
    ("cuda", 4, 2, 2, (["cuda:2", "cuda:3"], "nccl", "cuda:2")),
    ("cuda", 1, 2, 2, (["cuda:0"] * 2, "gloo", "cpu")),
    ("cuda", 2, 3, 1, (["cuda:1"], "gloo", "cpu")),
])
def test_placement(device, cards, nprocs, local, want, monkeypatch):
    """Rank 1's shards, backend and collective device: NCCL only when every
    rank has cards of its own, gloo over host tensors when ranks share."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    shards, backend, comm = multiproc._placement(1, nprocs, local, device)
    assert ([str(s) for s in shards], backend, str(comm)) == want
