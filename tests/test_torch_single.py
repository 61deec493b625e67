"""The single-item entry points of `dafs_tpu` in the port, against `dafs_tpu`
on the CPU.

Each is a thin wrapper over a batched function the port already has, and is
held at the tolerance its batched sibling is held to: McCaskill (the fold
models' `bp_posterior` and `bp_posterior_constrained`,
`ops/mccaskill.bp_posterior_fast`) at atol 3e-5 / rtol 3e-3
(`tests/test_torch_mccaskill.py`), CONTRAfold within 1e-5 and the pair-CRF
within 1e-6 (`tests/test_torch_contra.py`), the ProbCons pair-HMM at atol =
rtol = 1e-5 (`tests/test_torch_pairhmm.py`), the similarity DP bit for bit
(`tests/test_torch_consistency.py`).  The JAX side runs in one subprocess
with `XLA_FLAGS=--xla_cpu_max_isa=AVX`, as the CONTRA tests run it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dafs_tpu_torch import consistency as t_co
from dafs_tpu_torch.models import align_models as t_am
from dafs_tpu_torch.models import fold_models as t_fm
from dafs_tpu_torch.ops import contrafold as t_cf
from dafs_tpu_torch.ops import mccaskill as t_mc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1 = "GGGCGCAAGCCUUCGGGCAAGGCGCCCAUU"
S2 = "GGCGCAAGCUUCGGCAAGGCGCCAUCU"
CON = "((" + "?" * 26 + "))"          # a forced pair, read alike by both models
CON_MC = "xx" + "?" * 28               # McCaskill's unpaired mark
MC_TOL = dict(atol=3e-5, rtol=3e-3)
PH_TOL = dict(atol=1e-5, rtol=1e-5)

_JAX = """
import json, sys
import numpy as np
from dafs_tpu import consistency
from dafs_tpu.models import align_models, fold_models
from dafs_tpu.ops import contrafold, mccaskill
from dafs_tpu.parallel.mesh import force_single_device
a = json.loads(sys.stdin.read())
s1, s2, con, con_mc = a["s1"], a["s2"], a["con"], a["con_mc"]
out = {}
with force_single_device():
    rnafold = fold_models.RNAfold(True, 0.0)
    out["rnafold"] = rnafold.bp_posterior(s1)
    out["rnafold_con"] = rnafold.bp_posterior_constrained(s1, con)
    out["rnafold_con_mc"] = rnafold.bp_posterior_constrained(s1, con_mc)
    cf = fold_models.CONTRAfold(0.0)
    out["contrafold"] = cf.bp_posterior(s1)
    out["contrafold_con"] = cf.bp_posterior_constrained(s1, con)
    out["cf_bp"] = contrafold.bp_posterior(s1, 0.0, constraint=con)
    out["probcons"] = align_models.ProbCons(0.0).pair_posterior(s1, s2)
    out["contralign"] = align_models.CONTRAlign(0.0).pair_posterior(s1, s2)
    out["bp_fast"] = mccaskill.bp_posterior_fast(s1, 0.0)
    out["bp_fast_con"] = mccaskill.bp_posterior_fast(s1, 0.01, constraint=con_mc)
    mp = np.asarray(out["probcons"], np.float32)
    out["similarity"] = np.float32(consistency.similarity(mp, mp > 0, len(s1), len(s2)))
np.savez(a["out"], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "single.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", _JAX], text=True, capture_output=True, cwd=ROOT,
                   env=env, timeout=900, check=True,
                   input=json.dumps(dict(s1=S1, s2=S2, con=CON, con_mc=CON_MC, out=path)))
    return dict(np.load(path))


def _err(got, want):
    assert got.shape == want.shape
    return float(np.abs(got.astype(np.float64) - want).max())


def test_rnafold_single_items(jax_ref):
    m = t_fm.RNAfold(True, 0.0)
    np.testing.assert_allclose(m.bp_posterior(S1, "cpu"), jax_ref["rnafold"], **MC_TOL)
    got = m.bp_posterior_constrained(S1, CON, "cpu")
    np.testing.assert_allclose(got, jax_ref["rnafold_con"], **MC_TOL)
    assert not got[0, :-1].any() and not got[:, -1][1:].any()   # its ends pair with nothing else
    got = m.bp_posterior_constrained(S1, CON_MC, "cpu")
    np.testing.assert_allclose(got, jax_ref["rnafold_con_mc"], **MC_TOL)
    assert not got[:2].any() and not got[:, :2].any()


def test_bp_posterior_fast_single(jax_ref):
    np.testing.assert_allclose(t_mc.bp_posterior_fast(S1, 0.0, "cpu"), jax_ref["bp_fast"],
                               **MC_TOL)
    got = t_mc.bp_posterior_fast(S1, 0.01, "cpu", constraint=CON_MC)
    np.testing.assert_allclose(got, jax_ref["bp_fast_con"], **MC_TOL)
    assert got.max() > 0.5 and got[(got > 0) & (got <= 0.01)].size == 0


def test_contrafold_single_items(jax_ref):
    m = t_fm.CONTRAfold(0.0)
    assert _err(m.bp_posterior(S1, "cpu"), jax_ref["contrafold"]) <= 1e-5
    assert _err(m.bp_posterior_constrained(S1, CON, "cpu"), jax_ref["contrafold_con"]) <= 1e-5
    assert _err(t_cf.bp_posterior(S1, 0.0, "cpu", constraint=CON), jax_ref["cf_bp"]) <= 1e-5
    assert jax_ref["contrafold"].max() > 0.5


def test_align_models_single_items(jax_ref):
    np.testing.assert_allclose(t_am.ProbCons(0.0).pair_posterior(S1, S2, "cpu"),
                               jax_ref["probcons"], **PH_TOL)
    assert _err(t_am.CONTRAlign(0.0).pair_posterior(S1, S2, "cpu"), jax_ref["contralign"]) <= 1e-6


def test_similarity_single(jax_ref):
    """One pair's score equals `dafs_tpu`'s bit for bit, and the all-pairs
    matrix's entry for the same posteriors."""
    mp = jax_ref["probcons"].astype(np.float32)
    got = t_co.similarity(mp, mp > 0, len(S1), len(S2), "cpu")
    assert np.float32(got).view(np.int32) == jax_ref["similarity"].view(np.int32)
    L = max(len(S1), len(S2))
    full = np.zeros((2, 2, L, L), np.float32)
    full[0, 1, : len(S1), : len(S2)] = mp
    full[1, 0, : len(S2), : len(S1)] = mp.T
    assert t_co.similarity_matrix(full, [len(S1), len(S2)], "cpu")[0, 1] == np.float32(got)


def test_aux_fold_has_no_single_items(tmp_path):
    """An `AUXFold` holds no model to fold with, as in `dafs_tpu`."""
    path = tmp_path / "bp.txt"
    path.write_text("> 1\n")
    with pytest.raises(NotImplementedError):
        t_fm.AUXFold(str(path), 0.0).bp_posterior(S1, "cpu")
