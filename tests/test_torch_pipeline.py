"""The port's whole slice against `dafs_tpu`, its entry points, and its
independence from JAX.

The reference is `dafs_tpu.pipeline.Dafs(ProbCons(0.01), RNAfold(True,
CUTOFF), Options(use_alifold=False), alifold_model=None)`, run in a
subprocess with XLA's CPU code generation capped below FMA
(`--xla_cpu_max_isa=AVX`): by default XLA on the CPU contracts
multiply-adds into fused multiply-adds, which the port (like the TPU) never
does, and on the seeded family below that one rounding difference moves a
DD trajectory and one gap.  Without it, tree topology, SS_cons and the
gapped rows must be identical and the tree scores agree within 1e-4.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dafs_tpu_torch
from dafs_tpu_torch import cli
from dafs_tpu_torch.fasta import Fasta

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

TINY = [("a", "GGGCGCAAGCCU"), ("b", "GGGCGCUUGCCU"), ("c", "GGACGCAAGCCU")]


def _seeded_family(seed=1, n=5):
    """n mutated copies of one random 52-nt sequence (lengths 40-64)."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGU"), size=52))
    out = []
    for k in range(n):
        s = list(base)
        for _ in range(int(rng.integers(3, 9))):
            pos = int(rng.integers(0, len(s)))
            op = rng.integers(0, 3)
            if op == 0:
                s[pos] = rng.choice(list("ACGU"))
            elif op == 1 and len(s) > 40:
                del s[pos]
            elif len(s) < 64:
                s.insert(pos, rng.choice(list("ACGU")))
        out.append((f"s{k}", "".join(s)))
    return out


FAMILIES = {"three_hairpins": TINY, "seeded_5x52": _seeded_family()}

_JAX_REFERENCE = """
import json, sys
from dafs_tpu import pipeline
from dafs_tpu.fasta import Fasta
from dafs_tpu.models import align_models, fold_models
from dafs_tpu.parallel.mesh import force_single_device
out = {}
for name, recs in json.loads(sys.stdin.read()).items():
    with force_single_device():
        d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, 0.01),
                          pipeline.Options(use_alifold=False), alifold_model=None)
        d.run([Fasta(n, s) for n, s in recs])
    out[name] = d.result
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_REFERENCE], input=json.dumps(FAMILIES),
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600, check=True,
    )
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_slice_matches_jax(family, jax_reference):
    want = jax_reference[family]
    got = dafs_tpu_torch.align_and_fold(
        [Fasta(n, s) for n, s in FAMILIES[family]], device="cpu", use_alifold=False
    )
    assert NUM.sub("#", got.tree) == NUM.sub("#", want["tree"])
    for a, b in zip(NUM.findall(got.tree), NUM.findall(want["tree"])):
        assert abs(float(a) - float(b)) <= 1e-4
    assert got.ss_cons == want["ss_cons"]
    assert got.names == want["names"]
    assert got.rows == want["rows"]
    assert abs(got.score - want["score"]) <= 1e-4


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import dafs_tpu_torch\n"
        f"res = dafs_tpu_torch.align_and_fold({[s for _, s in TINY]!r}, device='cpu')\n"
        "assert not [m for m in sys.modules if m == 'dafs_tpu' or m.startswith('dafs_tpu.')]\n"
        "print(res.ss_cons)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.fullmatch(r"[().]+", proc.stdout.strip())


@pytest.fixture
def tiny_fa(tmp_path):
    p = tmp_path / "tiny.fa"
    p.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    return str(p)


def test_cli_matches_api(tiny_fa, capsys):
    assert cli.main(["--no-alifold", "--device", "cpu", tiny_fa]) == 0
    out = capsys.readouterr().out
    res = dafs_tpu_torch.align_and_fold(tiny_fa, device="cpu")
    assert out == str(res)
    lines = out.splitlines()
    assert lines[1] == ">SS_cons" and [l[2:] for l in lines[3::2]] == ["a", "b", "c"]
    assert all(r.replace("-", "") == s for r, (_, s) in zip(lines[4::2], TINY))


@pytest.mark.parametrize("argv", [
    [],                                   # the consensus mix
    ["-a", "CONTRAlign"],
    ["-s", "CONTRAfold"],
    ["--ipknot"],
    ["--fold-decoder", "IPknot"],
    ["-m", "0"],
    ["-v", "2"],
    ["-r", "1"],
    ["--bp-update"],
    ["--bp-update1"],
    ["-f", "0.5"],
    ["--align-aux", "mp.txt"],
    ["--fold-aux", "bp.txt"],
    ["--save-align-aux", "mp.txt"],
    ["-P", "rna_turner2004.par"],
    ["--dd-update", "adam"],
    ["--dd-update", "adagrad"],
])
def test_cli_options_outside_the_slice_raise(argv, tiny_fa):
    args = argv if argv == [] else ["--no-alifold", *argv]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main([*args, "--device", "cpu", tiny_fa])


@pytest.mark.parametrize("kw", [
    dict(use_alifold=True), dict(align_model="CONTRAlign"),
    dict(fold_model="CONTRAfold"), dict(n_refinement=2), dict(dd_update="adam"),
])
def test_api_options_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dafs_tpu_torch.align_and_fold([s for _, s in TINY], device="cpu", **kw)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        dafs_tpu_torch.align_and_fold([s for _, s in TINY])


def test_single_sequence():
    res = dafs_tpu_torch.align_and_fold(["GGGCGCAAGCCU"], names=["a"], device="cpu")
    assert res.tree == "a" and res.rows == ["GGGCGCAAGCCU"]
    assert res.ss_cons.count("(") == res.ss_cons.count(")")
