"""The port's copy of the IPknot decoder (`dafs_tpu_torch.decoders_ip.ipknot`)
against `dafs_tpu.decoders_ip.ipknot`, on the cases of tests/test_ipknot.py
and on random matrices.

Both modules are numpy and scipy (HiGHS) on the host, so the outputs must
be equal: structures, bracket strings and scores, `IPknotModel.solve` over
a drifting DD-style multiplier matrix, and `decompose_plevel`.
"""

import numpy as np
import pytest

from dafs_tpu.decoders_ip import ipknot as j_ipknot
from dafs_tpu_torch.decoders_ip import ipknot
from tests.test_ipknot import _random_ipknot_instance, _ss_from_pairs

TH2 = [0.2, 1 / 9.0]


def _helices(L, helices):
    p = np.zeros((L, L), np.float32)
    for i, j, n, v in helices:
        for k in range(n):
            p[i + k, j - k] = v
    return p


# the matrices of tests/test_ipknot.py: (p, thresholds, levelwise)
CASES = {
    "nested": (_helices(20, [(0, 19, 3, 0.9)]), TH2, True),
    "pseudoknot": (_helices(18, [(0, 10, 3, 0.9), (5, 15, 2, 0.8)]), TH2, True),
    "isolated": (_helices(16, [(2, 13, 1, 0.9)]), [0.2], True),
    "crossing_requirement": (_helices(20, [(0, 12, 3, 0.15)]), TH2, True),
    "non_levelwise": (_helices(30, [(0, 14, 2, 0.9), (4, 20, 2, 0.9), (8, 26, 2, 0.9)]),
                      [0.2, 0.1, 0.05], False),
    "empty": (np.zeros((9, 9), np.float32), TH2, True),
}


def _random_p(seed, L):
    rng = np.random.default_rng(seed)
    p = np.float32(rng.random((L, L)) * (rng.random((L, L)) < 0.12))
    return np.float32(np.triu(p, 1))


for _seed, _L in ((0, 24), (1, 40), (2, 33)):
    CASES[f"random_{_seed}_{_L}"] = (_random_p(_seed, _L), TH2, True)
CASES["random_three_levels"] = (_random_p(3, 30), [0.25, 0.15, 0.1], True)
CASES["random_non_levelwise"] = (_random_p(4, 28), TH2, False)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(case):
    p, th, levelwise = CASES[case]
    _same(ipknot.decode(p, th, levelwise=levelwise), j_ipknot.decode(p, th, levelwise=levelwise))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_with_weight_and_q_matches_jax(case):
    p, th, levelwise = CASES[case]
    q = np.float32(np.triu(np.random.default_rng(9).normal(0, 0.05, p.shape), 1))
    got = ipknot.decode(p, th, w=np.float32(4.0), q=q, levelwise=levelwise)
    _same(got, j_ipknot.decode(p, th, w=np.float32(4.0), q=q, levelwise=levelwise))


@pytest.mark.parametrize("seed", range(4))
def test_model_solve_with_q_matches_jax(seed):
    """The persistent model over the drifting multipliers of a DD loop."""
    rng = np.random.default_rng(seed)
    p, q, extra, th = _random_ipknot_instance(rng, L=20 + 5 * seed)
    w = np.float32(4.0)
    got_m = ipknot.IPknotModel(p, th, w, extra=extra)
    want_m = j_ipknot.IPknotModel(p, th, w, extra=extra)
    _same(got_m.solve(), want_m.solve())
    for _ in range(4):
        _same(got_m.solve(q), want_m.solve(q))
        q = np.float32(q + rng.normal(0, 0.02, q.shape))
        q = np.float32(np.triu(np.where(extra, q, np.abs(q)), 1))


@pytest.mark.parametrize("pairs,L", [
    ([(0, 14), (1, 13), (4, 20), (5, 19), (8, 26), (9, 25)], 30),
    ([(0, 11), (1, 10), (3, 8)], 12),
    ([(0, 6), (2, 12), (3, 11), (4, 10)], 14),
    ([], 5),
    ([(0, 9), (2, 12), (4, 15), (6, 18), (11, 20), (13, 22)], 24),
])
def test_decompose_plevel_matches_jax(pairs, L):
    ss = _ss_from_pairs(L, pairs)
    np.testing.assert_array_equal(ipknot.decompose_plevel(ss), j_ipknot.decompose_plevel(ss))


def test_highs_binding_is_the_same():
    """Both copies pick the same HiGHS binding (highspy, or scipy's core)."""
    assert ipknot._highs_core() is j_ipknot._highs_core()
