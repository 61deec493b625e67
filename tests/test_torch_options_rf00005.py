"""RF00005 (10 tRNAs, full width) under the last single-card options: the
port's CPU CLI prints `dafs_tpu.cli`'s bytes, recorded in
`tests/snapshots/rf00005_{refine2,fourway,adagrad,adam,param_file}_cpu.txt`
with `JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_max_isa=AVX python -m
dafs_tpu.cli FLAGS tests/data/RF00005_0.fa`.

`-r 2` and `-f 0.5` take about 40 s each on one CPU thread; the adagrad and
adam updates and `-P` (about as long each) carry the marker slow.
"""

import os

import pytest
import torch

from dafs_tpu_torch import cli
from dafs_tpu_torch.ops import energy_params

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR_FILE = os.path.join(ROOT, "tests", "data", "ml_ninio.par")


@pytest.mark.parametrize("flags,snapshot", [
    (["-r", "2"], "rf00005_refine2_cpu.txt"),
    (["-f", "0.5"], "rf00005_fourway_cpu.txt"),
    pytest.param(["--dd-update", "adagrad"], "rf00005_adagrad_cpu.txt", marks=pytest.mark.slow),
    pytest.param(["--dd-update", "adam"], "rf00005_adam_cpu.txt", marks=pytest.mark.slow),
    pytest.param(["-P", PAR_FILE], "rf00005_param_file_cpu.txt", marks=pytest.mark.slow),
], ids=["refine2", "fourway", "adagrad", "adam", "param_file"])
def test_rf00005_option_matches_snapshot(flags, snapshot, capsys):
    try:
        assert cli.main([*flags, "--device", "cpu",
                         os.path.join(ROOT, "tests", "data", "RF00005_0.fa")]) == 0
    finally:
        energy_params.set_param_overrides({})
    with open(os.path.join(ROOT, "tests", "snapshots", snapshot)) as fh:
        assert capsys.readouterr().out == fh.read()
