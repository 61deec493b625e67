"""The port's batched DD merge solver against `dafs_tpu` on the CPU.

Per merge, (x, y, z) must equal `dafs_tpu.dd.solve_by_dd_batch` exactly and
s to 1e-4, on problems that converge before the iteration cap (a capped
solve depends on the rounding of every iteration; these do not).
"""

import numpy as np
import pytest
import torch

from dafs_tpu import dd as j_dd
from dafs_tpu_torch import dd as t_dd

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

KW = dict(w=4.0, th_s=[0.2], th_a=0.01, eta0=0.5, t_max=600)


def _fake_merge_problem(rng, L1, L2):
    """Random but structured posteriors resembling a real merge step (as
    tests/test_dd.py builds them)."""
    p_x = np.zeros((L1, L1), np.float32)
    p_y = np.zeros((L2, L2), np.float32)
    p_z = np.zeros((L1, L2), np.float32)
    for i in range(L1):
        j = int(np.clip(round(i * L2 / L1) + rng.integers(-1, 2), 0, L2 - 1))
        p_z[i, j] = 0.4 + 0.6 * rng.random()
    for _ in range(L1):
        i = int(rng.integers(0, L1 - 4))
        j = int(rng.integers(i + 4, L1))
        p_x[i, j] = 0.3 + 0.7 * rng.random()
        k = int(np.clip(round(i * L2 / L1), 0, L2 - 1))
        l = int(np.clip(round(j * L2 / L1), 0, L2 - 1))
        if k + 3 < l:
            p_y[k, l] = 0.3 + 0.7 * rng.random()
    for _ in range(L2 // 2):
        k = int(rng.integers(0, L2 - 4))
        l = int(rng.integers(k + 4, L2))
        p_y[k, l] = max(p_y[k, l], 0.2 + 0.5 * rng.random())
    return p_x, p_y, p_z


def _problems(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n1, n2 in [(1, 1), (2, 1), (3, 2)]:
        L1 = int(rng.integers(12, 40))
        L2 = int(rng.integers(12, 40))
        out.append((*_fake_merge_problem(rng, L1, L2), n1, n2))
    return out


def _check(got, want):
    for (s_g, x_g, y_g, z_g), (s_w, x_w, y_w, z_w) in zip(got, want):
        np.testing.assert_array_equal(x_g, x_w)
        np.testing.assert_array_equal(y_g, y_w)
        np.testing.assert_array_equal(z_g, z_w)
        assert abs(s_g - s_w) <= 1e-4


@pytest.mark.parametrize("seed", [1, 16, 19])
def test_batch_matches_jax(seed):
    probs = _problems(seed)
    pr = t_dd.prep_batch(probs, w=KW["w"], th_s=KW["th_s"], th_a=KW["th_a"], device="cpu")
    _, t, violated, *_ = t_dd._dd_core(pr, th_s0=np.float32(0.2).item(),
                                       th_a=np.float32(0.01).item(), eta0=0.5,
                                       t_max=KW["t_max"])
    assert bool((violated == 0).all()) and bool((t < KW["t_max"]).all())
    _check(t_dd.solve_by_dd_batch(probs, device="cpu", **KW),
           j_dd.solve_by_dd_batch(probs, **KW))


def test_single_merge_matches_jax():
    p_x, p_y, p_z, n1, n2 = _problems(2)[1]
    got = t_dd.solve_by_dd(p_x, p_y, p_z, n1, n2, device="cpu", **KW)
    want = j_dd.solve_by_dd(p_x, p_y, p_z, n1, n2, **KW)
    _check([got], [want])


def test_frozen_merges_do_not_move():
    """A merge that converged keeps its result while others iterate on:
    solving it alone or inside a batch gives the same (s, x, y, z)."""
    probs = _problems(14)  # converge after 37, 82 and 170 iterations
    batch = t_dd.solve_by_dd_batch(probs, device="cpu", **KW)
    for p, b in zip(probs, batch):
        alone = t_dd.solve_by_dd(*p, device="cpu", **KW)
        assert alone[0] == b[0]
        for u, v in zip(alone[1:], b[1:]):
            np.testing.assert_array_equal(u, v)


def test_other_update_rules_run():
    """adagrad and adam solve every merge of a batch; the iterations and
    violations at exit are reported per merge (their results against
    `dafs_tpu` are held in tests/test_torch_options.py)."""
    for rule in ("adagrad", "adam"):
        stats = []
        out = t_dd.solve_by_dd_batch(_problems(1), device="cpu", update_rule=rule,
                                     stats=stats, **KW)
        assert len(out) == len(stats) == 3
        assert all(0 < t < KW["t_max"] and v == 0 for t, v in stats)
    assert torch.get_default_dtype() == torch.float32
