"""The port's bp-update (`Dafs._update_bp`, `--bp-update`, `--bp-update1`)
and the CONTRA model pair (`-s CONTRAfold -a CONTRAlign`) against
`dafs_tpu` on the CPU.

`_update_bp` is held, with the fake models of
tests/test_untested_features.py, to that file's scalar oracle and bit for
bit to the JAX package's own `_update_bp`, at one and two bracket levels.
The whole paths run on two small families against `dafs_tpu`'s `Dafs` of
the same arguments, in one subprocess with XLA's CPU code generation capped
below FMA (`--xla_cpu_max_isa=AVX`), which the port never contracts: tree
topology, `SS_cons`, rows, and the route and ladder attempts of every
consensus call must be equal, the tree scores within 1e-4.  The port's runs
are made while that subprocess runs.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dafs_tpu import pipeline as j_pipeline
from dafs_tpu_torch import pipeline
from dafs_tpu_torch.fasta import Fasta
from dafs_tpu_torch.models import align_models, fold_models
from dafs_tpu_torch.ops import alifold
from dafs_tpu_torch.typedefs import CUTOFF, AlnRow
from tests.test_torch_pipeline import FAMILIES
from tests.test_untested_features import (
    _bp_update_oracle, _FakeAlifold, _FakeFold, _FakeSeq,
)

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


# ------------------------------------------------------------ _update_bp --


class _PortFold(_FakeFold):
    def batch_bp_posteriors(self, seqs, device, th=None, constraints=None):
        return super().batch_bp_posteriors(seqs, constraints)


class _PortAlifold(_FakeAlifold):
    def consensus_bp(self, aln, fa, device, constraint=None):
        return super().consensus_bp(aln, fa, constraint)


FA = [_FakeSeq("a", "GGGAACCCUU"), _FakeSeq("b", "GGAAACCCU"), _FakeSeq("c", "GGGAACCCU")]
ALN = [AlnRow(i, np.array(m, bool)) for i, m in enumerate([
    [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0],
    [0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
])]
# level-0 pairs (0,9), (1,8); level-1 pair (3,10)
SS = np.full(11, -1, np.int64)
SS[0], SS[1], SS[3] = 9, 8, 10
SSTR = "((.[....))]"


def _dafs(make, fold, ali, th_s):
    d = make(fold, ali, th_s)
    d.fa = FA
    return d


def _port_dafs(fold, ali, th_s):
    return pipeline.Dafs(None, fold, pipeline.Options(th_s=th_s), alifold_model=ali,
                         device="cpu")


def _jax_dafs(fold, ali, th_s):
    return j_pipeline.Dafs(None, fold, j_pipeline.Options(th_s=th_s), alifold_model=ali)


@pytest.mark.parametrize("use_alifold", [True, False])
@pytest.mark.parametrize("th_s", [(0.2,), (0.2, 1 / 9.0)])
def test_update_bp_matches_oracle_and_jax(th_s, use_alifold):
    got_d = _dafs(_port_dafs, _PortFold(), _PortAlifold() if use_alifold else None, th_s)
    got = got_d._update_bp(None, SS, SSTR, ALN, use_alifold)
    want = _bp_update_oracle(FA, ALN, SS, SSTR, th_s, use_alifold)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    jax_d = _dafs(_jax_dafs, _FakeFold(), _FakeAlifold() if use_alifold else None, th_s)
    np.testing.assert_array_equal(got, jax_d._update_bp(None, SS, SSTR, ALN, use_alifold))
    # one re-fold per sequence and bracket level, in the JAX package's order
    assert got_d.s_model.calls == jax_d.s_model.calls
    assert len(got_d.s_model.calls) == len(FA) * len(th_s)
    if use_alifold:
        assert got_d.alifold.calls == jax_d.alifold.calls
        assert len(got_d.alifold.calls) == len(th_s)


def test_update_bp_skips_pairs_lost_to_gaps():
    """A pair whose partner column is a gap in a sequence leaves that
    sequence's constraint untouched."""
    fa = [_FakeSeq("a", "GGAACC"), _FakeSeq("b", "GGAACCU")]
    aln = [AlnRow(0, np.array([1, 1, 1, 1, 1, 1, 0], bool)), AlnRow(1, np.ones(7, bool))]
    ss = np.full(7, -1, np.int64)
    ss[0] = 6
    d = pipeline.Dafs(None, _PortFold(), pipeline.Options(), device="cpu")
    d.fa = fa
    got = d._update_bp(None, ss, "(.....)", aln, False)
    np.testing.assert_allclose(got, _bp_update_oracle(fa, aln, ss, "(.....)", (0.2,), False),
                               rtol=1e-6, atol=1e-7)
    assert d.s_model.calls[0][1] == "??????"
    assert d.s_model.calls[1][1][0] == "(" and d.s_model.calls[1][1][6] == ")"


# ------------------------------------------------------------- the paths --

# (align model, fold model, Options fields): path (a), path (b), CONTRAfold
# under bp-update, and bp-update at two bracket levels (-g 4,8)
CONFIGS = {
    "a": ("CONTRAlign", "CONTRAfold", {}),
    "b": ("ProbCons", "Boltzmann", dict(use_bp_update=True, use_bp_update1=True)),
    "contrafold_bp_update": ("CONTRAlign", "CONTRAfold",
                             dict(use_bp_update=True, use_bp_update1=True)),
    "b_two_levels": ("ProbCons", "Boltzmann",
                     dict(use_bp_update=True, use_bp_update1=True, th_s=(0.2, 1 / 9.0))),
}
CASES = [(c, f) for c in CONFIGS for f in sorted(FAMILIES)
         if c != "b_two_levels" or f == "three_hairpins"]

_JAX_REFERENCE = """
import json, sys
from dafs_tpu import pipeline
from dafs_tpu.fasta import Fasta
from dafs_tpu.models import align_models, fold_models
from dafs_tpu.ops import alifold
from dafs_tpu.ops import alifold_kernel
from dafs_tpu.parallel.mesh import force_single_device

# record every consensus call as the port does: (n_seq, n, route, attempts)
calls = []
_consensus, _fast = alifold.consensus_bp, alifold_kernel.alifold_fast
def consensus_bp(seqs, *a, **k):
    single = len(seqs) == 1 and "-" not in seqs[0] and "_" not in seqs[0]
    calls.append([len(seqs), len(seqs[0]), "mccaskill" if single else "alifold",
                  None if single else 0])
    return _consensus(seqs, *a, **k)
def alifold_fast(*a, **k):
    calls[-1][3] += 1
    return _fast(*a, **k)
alifold.consensus_bp, alifold_kernel.alifold_fast = consensus_bp, alifold_fast

args = json.loads(sys.stdin.read())
out = {}
for case, (am, fm, opts), recs in args["runs"]:
    alifold._SC_CACHE.clear()
    calls.clear()
    s_model = (fold_models.CONTRAfold(0.01) if fm == "CONTRAfold"
               else fold_models.RNAfold(fm == "Boltzmann", 0.01))
    a_model = align_models.CONTRAlign(0.01) if am == "CONTRAlign" else align_models.ProbCons(0.01)
    opts = dict(opts, th_s=tuple(opts.get("th_s", (0.2,))))
    with force_single_device():
        d = pipeline.Dafs(a_model, s_model, pipeline.Options(**opts),
                          alifold_model=alifold.Alifold(0.0, bl=fm == "Boltzmann"))
        d.run([Fasta(n, s) for n, s in recs])
    out[case] = dict(d.result, calls=[list(c) for c in calls])
print(json.dumps(out))
"""


def _port_run(config, family):
    am, fm, opts = CONFIGS[config]
    d = pipeline.Dafs(
        align_models.by_name(am, 0.01), fold_models.by_name(fm, CUTOFF),
        pipeline.Options(**opts), alifold_model=alifold.Alifold(0.0, bl=fm == "Boltzmann"),
        device="cpu",
    )
    d.run([Fasta(n, s) for n, s in FAMILIES[family]])
    return d.result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case: (port result, JAX result)}: the port's runs are made while the
    JAX reference runs in its subprocess."""
    tmp = tmp_path_factory.mktemp("jax")
    (tmp / "args.json").write_text(json.dumps(dict(
        runs=[(f"{c}/{f}", CONFIGS[c], FAMILIES[f]) for c, f in CASES])))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    with open(tmp / "args.json") as fin, open(tmp / "out", "w") as fout, \
            open(tmp / "err", "w") as ferr:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_REFERENCE], stdin=fin,
                                stdout=fout, stderr=ferr, cwd=ROOT, env=env)
        try:
            got = {f"{c}/{f}": _port_run(c, f) for c, f in CASES}
            proc.wait(timeout=1200)
        finally:
            proc.kill()
    assert proc.returncode == 0, (tmp / "err").read_text()[-3000:]
    want = json.loads((tmp / "out").read_text().strip().splitlines()[-1])
    return {k: (got[k], want[k]) for k in got}


@pytest.mark.parametrize("config,family", CASES)
def test_path_matches_jax(config, family, results):
    _, _, opts = CONFIGS[config]
    got, want = results[f"{config}/{family}"]
    assert NUM.sub("#", got["tree"]) == NUM.sub("#", want["tree"])
    for a, b in zip(NUM.findall(got["tree"]), NUM.findall(want["tree"])):
        assert abs(float(a) - float(b)) <= 1e-4
    assert got["ss_cons"] == want["ss_cons"]
    assert got["names"] == want["names"] and got["rows"] == want["rows"]
    assert abs(got["score"] - want["score"]) <= 1e-4
    # the port serves unconstrained leaf groups from the fold stage's own
    # McCaskill run, which is the JAX package's single-sequence route
    routes = [[c["ns"], c["n"], "mccaskill" if c["route"] == "fold stage" else c["route"],
               c["attempts"]] for c in got["consensus_calls"]]
    assert routes == want["calls"]
    # per merge, each side's consensus and, under bp-update, one constrained
    # consensus per bracket level; then the final structure's
    levels = len(opts.get("th_s", (0.2,)))
    per_side = 1 + (levels if opts.get("use_bp_update") else 0)
    final = 1 + (levels if opts.get("use_bp_update1") else 0)
    assert len(routes) == (len(FAMILIES[family]) - 1) * 2 * per_side + final
