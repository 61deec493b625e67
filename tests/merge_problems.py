"""Seeded random merge problems for the host-solver tests: numpy only, so
that the card's tests (which run without JAX) use them too."""

import numpy as np

KW = dict(w=4.0, th_s=[0.2], th_a=0.01, eta0=0.5)


def _helix_probs(rng, L, n_helix):
    """Upper-triangle base-pair probabilities: a few stems plus noise."""
    p = np.zeros((L, L), np.float32)
    for _ in range(n_helix):
        if L < 8:
            break
        i = int(rng.integers(0, L - 7))
        j = int(rng.integers(i + 6, L))
        for k in range(int(rng.integers(2, 5))):
            if i + k < j - k - 3:
                p[i + k, j - k] = 0.5 + 0.45 * rng.random()
    noise = (rng.random((L, L)) < 0.04) * rng.random((L, L)) * 0.4
    return np.float32(np.triu(np.maximum(p, noise), 1))


def _problem(seed, L1, L2):
    """A merge's (p_x, p_y, p_z): stems on both sides and match
    probabilities along the diagonal band, with noise."""
    rng = np.random.default_rng(seed)
    p_x, p_y = _helix_probs(rng, L1, 4), _helix_probs(rng, L2, 4)
    p_z = np.zeros((L1, L2), np.float32)
    for i in range(L1):
        k = int(round(i * L2 / max(L1, 1))) + int(rng.integers(-1, 2))
        if 0 <= k < L2:
            p_z[i, k] = 0.3 + 0.7 * rng.random()
    p_z = np.float32(np.maximum(p_z, (rng.random((L1, L2)) < 0.05) * rng.random((L1, L2)) * 0.3))
    return p_x, p_y, p_z


# (seed, L1, L2, n1, n2): true lengths around the 32-padding, 1, and ragged pairs
PROBLEMS = [(0, 1, 1, 1, 1), (1, 1, 9, 1, 2), (2, 31, 33, 1, 1), (3, 32, 32, 2, 1),
            (4, 33, 31, 1, 3), (5, 20, 45, 2, 2), (6, 40, 17, 3, 1)]
