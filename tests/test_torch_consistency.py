"""The port's similarity DP and PCT against `dafs_tpu` on the CPU.

The similarity DP is max-plus code and must match bit for bit; the PCT
products use matrix multiplies whose sums reduce in another order, held to
atol 2e-6 as in tests/test_consistency.py.
"""

import numpy as np
import pytest
import torch

from dafs_tpu import consistency as j_co
from dafs_tpu.parallel.mesh import force_single_device
from dafs_tpu_torch import consistency as t_co

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _family(seed, N=4, lens=(12, 14, 13, 12)):
    rng = np.random.default_rng(seed)
    L = max(lens)
    mp = np.zeros((N, N, L, L), np.float32)
    bp = np.zeros((N, L, L), np.float32)
    for x in range(N):
        mp[x, x][np.arange(lens[x]), np.arange(lens[x])] = 1.0
        for _ in range(6):
            i = int(rng.integers(0, lens[x] - 4))
            j = int(rng.integers(i + 3, lens[x]))
            bp[x, i, j] = 0.2 + 0.8 * rng.random()
        for y in range(x + 1, N):
            for i in range(lens[x]):
                j = int(np.clip(round(i * lens[y] / lens[x] + rng.integers(-1, 2)), 0, lens[y] - 1))
                mp[x, y, i, j] = 0.3 + 0.7 * rng.random()
                if rng.random() < 0.2:
                    mp[x, y, i, int(rng.integers(0, lens[y]))] = 0.05 + 0.2 * rng.random()
            mp[y, x] = mp[x, y].T
    sim = (0.6 + 0.4 * rng.random((N, N))).astype(np.float32)
    sim = np.float32((sim + sim.T) / 2)
    np.fill_diagonal(sim, 1.0)
    return mp, bp, sim, list(lens)


@pytest.mark.parametrize("seed", range(3))
def test_similarity_matrix_bit_equal(seed):
    mp, _, _, lens = _family(seed)
    want = j_co.similarity_matrix(mp, lens)
    got = t_co.similarity_matrix(mp, lens, "cpu")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("w_pct", [0.25, -1.0])
def test_relax_matching_matches_jax(w_pct):
    mp, _, sim, lens = _family(5)
    with force_single_device():
        want = j_co.relax_matching_probability(mp, sim, lens, w_pct)
    got = t_co.relax_matching_probability(mp, sim, lens, w_pct, "cpu")
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("w_pct", [0.25, -1.0])
def test_relax_basepairing_matches_jax(w_pct):
    mp, bp, sim, lens = _family(6, N=3, lens=(12, 14, 13))
    with force_single_device():
        want = j_co.relax_basepairing_probability(bp, mp, sim, lens, w_pct)
    got = t_co.relax_basepairing_probability(bp, mp, sim, lens, w_pct, "cpu")
    np.testing.assert_allclose(got, want, atol=2e-6)
