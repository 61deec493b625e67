"""The plain versions past the CUDA kernels' old length limits, on the CPU.

On the card, shapes past the limits of the main path's kernels (1024 rows
for K1/K2, padded length 1024 for K3, 1023 columns or a block's shared
memory for K4) go to the long variants, which `chip_smoke.py` and
tests/test_torch_cuda.py hold bit-equal to these plain versions.  Here the
plain versions are held at one such shape each to `dafs_tpu`: the Nussinov
and NW decodes bit for bit to its native decoders (`dafs_tpu.native`,
themselves bit-equal to its device decoders, tests/test_native.py), the
pair-HMM posteriors bit for bit to its `forward_backward_posterior` run in
a subprocess with XLA's CPU code generation capped below FMA, as in
tests/test_torch_pairhmm_edges.py (in this process, with FMA, the 1095
diagonals drift apart by up to 2e-4).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from dafs_tpu import native
from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda, pairhmm, pairhmm_cuda
from tests.test_torch_pairhmm_edges import _JAX_NO_FMA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _structure_scores(rng, n):
    p = np.zeros((n, n), np.float32)
    for _ in range(3 * n):
        i = int(rng.integers(0, n - 3))
        j = int(rng.integers(i + 3, n))
        p[i, j] = rng.random()
    q = (rng.random((n, n)) * 0.2).astype(np.float32)
    return np.float32(np.float32(4.0) * (p - np.float32(0.2)) - q)


def test_nussinov_plain_past_the_kernel_limit():
    """Padded length 1056 (> nussinov_cuda.MAX_L), true length 1041."""
    L, n = 1056, 1041
    assert L > nussinov_cuda.MAX_L
    sm = _structure_scores(np.random.default_rng(0), n)
    pad = np.full((1, L, L), np.float32(-0.8), np.float32)
    pad[0, :n, :n] = sm
    score, ss = nussinov.decode_plain(torch.from_numpy(pad), torch.tensor([n], dtype=torch.int32))
    want_score, want_ss = native.sparse_nussinov(sm)
    assert float(score[0]) == want_score
    np.testing.assert_array_equal(ss[0, :n].numpy(), want_ss)
    assert (ss[0, n:] == -1).all() and (want_ss >= 0).sum() > 50


def _alignment_scores(rng, n1, n2, th=np.float32(0.01)):
    p = np.zeros((n1, n2), np.float32)
    for i in range(n1):
        j = int(np.clip(round(i * n2 / n1 + rng.integers(-3, 4)), 0, n2 - 1))
        p[i, j] = 0.3 + 0.7 * rng.random()
    q = (rng.random((n1, n2)) * 0.1).astype(np.float32)
    return np.float32(p - th + q), nw.envelope(p, th)


def test_nw_plain_past_the_kernel_limits():
    """800 x 992 (beyond one block's shared memory for the codes) and
    48 x 1056 (beyond 1023 columns), at true lengths below the padding."""
    rng = np.random.default_rng(1)
    for L1, L2, n1, n2 in ((800, 992, 790, 977), (48, 1056, 41, 1040)):
        assert nw_cuda.is_long(L1, L2)
        sm, env = _alignment_scores(rng, n1, n2)
        pad = np.full((1, L1, L2), np.float32(-0.01), np.float32)
        pad[0, :n1, :n2] = sm
        envf = np.zeros((1, L1 + 1), np.int32)
        envl = np.full((1, L1 + 1), n2, np.int32)
        envf[0, : n1 + 1] = env[:, 0]
        envl[0, : n1 + 1] = env[:, 1]
        as_t = torch.from_numpy
        score, al = nw.decode_plain(as_t(pad), as_t(envf), as_t(envl),
                                    torch.tensor([n1], dtype=torch.int32),
                                    torch.tensor([n2], dtype=torch.int32))
        want_score, want_al = native.sparse_nw(sm, env)
        assert float(score[0]) == want_score
        np.testing.assert_array_equal(al[0, :n1].numpy(), want_al)
        assert (al[0, n1:] == -1).all()


def test_pairhmm_plain_past_the_kernel_limit():
    """imax = 1056 rows (> pairhmm_cuda.MAX_IMAX) against 40 columns."""
    rng = np.random.default_rng(2)
    l1max, l2max = 1055, 40
    assert l1max + 1 > pairhmm_cuda.MAX_IMAX
    s1 = ["".join(rng.choice(list("ACGU"), size=n)) for n in (1055, 1001)]
    s2 = ["".join(rng.choice(list("ACGU"), size=n)) for n in (33, 40)]
    c1, n1 = pairhmm.encode_batch(s1, l1max)
    c2, n2 = pairhmm.encode_batch(s2, l2max)
    got = pairhmm.forward_backward_posterior(
        *(torch.from_numpy(a) for a in (c1, n1, c2, n2)), pairhmm.tables("cpu")).numpy()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_NO_FMA],
        input=json.dumps(dict(c1=c1.tolist(), n1=n1.tolist(), c2=c2.tolist(), n2=n2.tolist())),
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600, check=True,
    )
    want = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]), np.uint32)
    assert got.shape == want.shape == (2, l1max, l2max)
    assert np.array_equal(got.view(np.uint32), want)
    assert got.max() > 0.5
