"""Edges of the port's pair-HMM that its CUDA kernels lean on, on the CPU.

The kernels (`csrc/pairhmm.cu`) walk only the diagonals inside the true
lengths, hand rows over between lanes and warps of 32, and choose the pieces
of LOG_ADD and EXP by selects.  They are held bit-equal to the plain versions
on the card; these tests pin the plain versions to `dafs_tpu` where that
design has its edges: lengths around a warp's 32 rows, unequal and
rectangular shapes, a length equal to the padded length, one pair, the
LOG_ZERO contract outside the true lengths, and the piece boundaries.

Tolerance against JAX in this process: atol = rtol = 1e-5, as
tests/test_torch_pairhmm.py (XLA on the CPU fuses multiply-adds).  One case
runs the JAX side in a subprocess with `--xla_cpu_max_isa=AVX`, where it does
not, and there the two must agree bit for bit.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafs_tpu.ops import logspace as j_ls
from dafs_tpu.ops import pairhmm as j_ph
from dafs_tpu_torch.ops import logspace as t_ls
from dafs_tpu_torch.ops import pairhmm as t_ph

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
F = np.float32

# name -> (lengths of seq1, lengths of seq2, l1max, l2max)
BATCHES = {
    "ragged_around_32": ([1, 2, 31, 32, 33, 64], [64, 33, 32, 31, 2, 1], 64, 64),
    "wide_32x96": ([1, 32, 17, 30], [96, 90, 2, 33], 32, 96),
    "tall_96x32": ([96, 90, 2, 33], [1, 32, 17, 30], 96, 32),
    "full_length": ([32, 32, 5], [32, 7, 32], 32, 32),
    "one_pair": ([23], [29], 32, 32),
}


def _batch(name):
    lens1, lens2, l1max, l2max = BATCHES[name]
    rng = np.random.default_rng(sorted(BATCHES).index(name))
    s1 = ["".join(rng.choice(list("ACGU"), size=n)) for n in lens1]
    s2 = ["".join(rng.choice(list("ACGU"), size=n)) for n in lens2]
    c1, n1 = t_ph.encode_batch(s1, l1max)
    c2, n2 = t_ph.encode_batch(s2, l2max)
    return c1, n1, c2, n2


def _passes(name):
    args = [torch.from_numpy(a) for a in _batch(name)]
    tab = t_ph.tables("cpu")
    fm, fcap = t_ph.forward_plain(*args, tab)
    bm, bcap = t_ph.backward_plain(*args, tab)
    post = t_ph.posterior(fm, fcap, bm, bcap, args[1], args[3], tab)
    return args, fm, bm, post


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_edge_posteriors_match_lax(name):
    c1, n1, c2, n2 = _batch(name)
    want = np.asarray(j_ph.forward_backward_posterior(
        jnp.asarray(c1), jnp.asarray(n1), jnp.asarray(c2), jnp.asarray(n2),
        l1max=c1.shape[1] - 1, l2max=c2.shape[1] - 1,
    ))
    got = _passes(name)[3].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


_JAX_NO_FMA = """
import json, sys
import jax.numpy as jnp
import numpy as np
from dafs_tpu.ops import pairhmm
a = json.loads(sys.stdin.read())
c1, n1, c2, n2 = (np.asarray(a[k], np.int32) for k in ("c1", "n1", "c2", "n2"))
post = np.asarray(pairhmm.forward_backward_posterior(
    jnp.asarray(c1), jnp.asarray(n1), jnp.asarray(c2), jnp.asarray(n2),
    l1max=c1.shape[1] - 1, l2max=c2.shape[1] - 1), np.float32)
print(json.dumps(post.view(np.uint32).tolist()))
"""


def test_edge_posteriors_equal_lax_bitwise_without_fma():
    c1, n1, c2, n2 = _batch("ragged_around_32")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_NO_FMA],
        input=json.dumps(dict(c1=c1.tolist(), n1=n1.tolist(), c2=c2.tolist(), n2=n2.tolist())),
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600, check=True,
    )
    want = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]), np.uint32)
    got = _passes("ragged_around_32")[3].numpy().view(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_log_zero_outside_true_lengths(name):
    """The kernels write the cells outside the true lengths in one filling
    pass and never visit them in the diagonal loop: the plain versions must
    hold exactly LOG_ZERO there, and fm also in row 0 and column 0."""
    (_, n1, _, n2), fm, bm, _ = _passes(name)
    lz = torch.tensor(t_ls.LOG_ZERO, dtype=torch.float32)
    i = torch.arange(fm.shape[1])[None, :, None]
    j = torch.arange(fm.shape[2])[None, None, :]
    dead = (i > n1[:, None, None]) | (j > n2[:, None, None])
    assert torch.all(fm[dead] == lz) and torch.all(bm[dead] == lz)
    edge = ((i == 0) | (j == 0)).expand_as(fm)
    assert torch.all(fm[edge] == lz)
    live = ~dead & (i > 0) & (j > 0)
    assert torch.all(fm[live] > lz) and torch.all(bm[live] > lz)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_posterior_masked_and_in_unit_interval(name):
    """Exactly 0 outside the true lengths; inside, at most 1 and never below
    the dip of the EXP quartic's last piece, which runs a few 1e-6 under 0
    just above -16 (in the reference and in `dafs_tpu` alike)."""
    (_, n1, _, n2), _, _, post = _passes(name)
    i = torch.arange(1, post.shape[1] + 1)[None, :, None]
    j = torch.arange(1, post.shape[2] + 1)[None, None, :]
    outside = (i > n1[:, None, None]) | (j > n2[:, None, None])
    assert torch.all(post[outside] == 0.0)
    assert float(post.min()) >= -1e-5 and float(post.max()) <= 1.0
    assert float(post[~outside].max()) > 0.0


def _neighbours(v):
    v = F(v)
    return np.array([np.nextafter(v, F(-np.inf)), v, np.nextafter(v, F(np.inf))], F)


def _poly(x, coeffs):
    """Horner in float32, every multiply and add rounded on its own."""
    acc = F(coeffs[0])
    for c in coeffs[1:]:
        acc = F(F(acc * x) + F(c))
    return acc


def _exp_scalar(x):
    """ScoreType.h:37-57 for x <= 0, one value at a time."""
    for coeffs, lower in t_ls.EXP_PIECES:
        if x > F(lower):
            return _poly(x, coeffs)
    return F(0.0)


def _log_add_scalar(x, y):
    """ScoreType.h:259-262 with LOOKUP (:187-198), one pair at a time."""
    hi, lo = max(x, y), min(x, y)
    d = F(hi - lo)
    if lo == F(t_ls.LOG_ZERO) or d >= F(t_ls.LOG_UNDERFLOW):
        return hi
    for coeffs, upper in t_ls.LOOKUP_PIECES:
        if upper is None or d <= F(upper):
            return F(_poly(d, coeffs) + lo)
    raise AssertionError


@pytest.mark.parametrize("boundary", [-0.5, -1.0, -2.0, -4.0, -8.0, -16.0, 0.0])
def test_probcons_exp_at_piece_boundaries(boundary):
    """The piece is chosen by `x > lower`: the boundary itself belongs to the
    next piece down.  The CUDA selects reproduce exactly these choices."""
    x = _neighbours(boundary)
    x = x[x <= 0]
    if boundary == 0.0:
        x = np.append(x, F(-0.0))
    got = t_ls.probcons_exp(torch.from_numpy(x)).numpy()
    want = np.array([_exp_scalar(v) for v in x], F)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(got, np.asarray(j_ls.probcons_exp(x)), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("diff", [1.0, 2.5, 4.5, 7.5, 0.0])
@pytest.mark.parametrize("hi", [0.0, -3.25, 11.5])
def test_log_add_at_piece_boundaries(diff, hi):
    """Differences at a LOOKUP boundary and one float32 step to each side,
    in both operand orders; hi - lo is exact for these values."""
    lo = F(hi) - _neighbours(diff)
    lo = lo[lo <= F(hi)]
    assert np.all(F(hi) - lo == F(F(hi) - lo))
    x = np.concatenate([np.full_like(lo, hi), lo])
    y = np.concatenate([lo, np.full_like(lo, hi)])
    got = t_ls.log_add(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.array([_log_add_scalar(a, b) for a, b in zip(x, y)], F)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(got, np.asarray(j_ls.log_add(x, y)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("other", [t_ls.LOG_ZERO, 0.0, -7.25, 3.0e20, -3.0e20])
def test_log_add_with_log_zero(other):
    """LOG_ZERO as either operand returns the larger operand: the backward
    kernel takes `max` for its LOG_ADDs onto LOG_ZERO."""
    lz = F(t_ls.LOG_ZERO)
    x = np.array([lz, other], F)
    y = np.array([other, lz], F)
    got = t_ls.log_add(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.array_equal(got, np.maximum(x, y))
    assert np.array_equal(got, np.asarray(j_ls.log_add(x, y)))
