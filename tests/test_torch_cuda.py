"""The port's CUDA kernels on the card (marker `cuda`).

These need an NVIDIA GPU and nvcc, so they skip where
`torch.cuda.is_available()` is false.  On the card (which has no JAX, so
the JAX-importing tests/conftest.py is not loaded):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

`chip_smoke.py` repeats the kernel comparison at the main path's shapes.
"""

import ctypes

import numpy as np
import pytest
import torch

from dafs_tpu_torch.ops import (
    alifold, cuda_lib, nussinov, nussinov_cuda, nw, nw_cuda, pairhmm, pairhmm_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pairhmm_args(dev, rng, lmax=64):
    seqs = ["".join(rng.choice(list("ACGU"), size=n)) for n in (40, 57, 61)]
    c, n = pairhmm.encode_batch(seqs, lmax)
    return [torch.from_numpy(a).to(dev) for a in (c, n, c[::-1].copy(), n[::-1].copy())]


def _decoder_args(dev, rng, L=64):
    sm = torch.from_numpy(rng.integers(-2, 3, size=(3, L, L)).astype(np.float32)).to(dev)
    lens = torch.tensor([L, 50, 33], dtype=torch.int32, device=dev)
    env_f = torch.zeros((3, L + 1), dtype=torch.int32, device=dev)
    env_l = torch.full((3, L + 1), L, dtype=torch.int32, device=dev)
    return sm, lens, (sm, env_f, env_l, lens, lens.flip(0).contiguous())


@pytest.mark.parametrize("module,attr", [
    (pairhmm_cuda, "FORWARD"), (pairhmm_cuda, "BACKWARD"),
    (nussinov_cuda, "DECODE"), (nw_cuda, "DECODE"),
])
def test_broken_library_raises(module, attr, dev, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: a wrapper whose library
    lacks its launcher must not hand back the plain version's result."""
    kernel = getattr(module, attr)
    broken = cuda_lib.CudaKernel(kernel.symbol, kernel.argtypes,
                                 loader=lambda: ctypes.CDLL(None))
    monkeypatch.setattr(module, attr, broken)
    rng = np.random.default_rng(0)
    sm, lens, nw_args = _decoder_args(dev, rng)
    with pytest.raises(AttributeError):
        if module is pairhmm_cuda:
            run = pairhmm.forward if attr == "FORWARD" else pairhmm.backward
            run(*_pairhmm_args(dev, rng), pairhmm.tables(dev))
        elif module is nussinov_cuda:
            nussinov.decode(sm, lens)
        else:
            nw.decode(*nw_args)
    assert broken.launches == 0


def test_kernels_match_plain_versions(dev):
    rng = np.random.default_rng(1)
    args = _pairhmm_args(dev, rng)
    tab = pairhmm.tables(dev)
    for got, want in ((pairhmm.forward(*args, tab), pairhmm.forward_plain(*args, tab)),
                      (pairhmm.backward(*args, tab), pairhmm.backward_plain(*args, tab))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    sm, lens, nw_args = _decoder_args(dev, rng)
    for g, w in zip(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens)):
        assert torch.equal(g, w)
    for g, w in zip(nw.decode(*nw_args), nw.decode_plain(*nw_args)):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError, match="float32"):
        nussinov_cuda.decode(torch.zeros((1, 32, 32), dtype=torch.float64, device=dev),
                             torch.tensor([32], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        nw_cuda.decode(torch.zeros((1, 8, 8)), torch.zeros((1, 9), dtype=torch.int32),
                       torch.zeros((1, 9), dtype=torch.int32),
                       torch.tensor([8], dtype=torch.int32), torch.tensor([8], dtype=torch.int32))


@pytest.mark.parametrize("seqs", [
    ["GGGC-AAAGCCC", "GG-CAAA-GCCC", "GGGCAA--GCCC"],
    ["GGGCAACGACGG--UUCGUCG--AAACCC", "GGGCAACG--GGCAUUCG--GCAAACCC-",
     "GGGCA--GACGGCAUU--UCGGCAAACC-"],
    ["GGGGAAAAAAAAAAAACCCC----", "GGGG------------AAAACCCC"],   # BCUT 16
    ["GGGGGGCCCCCC" * 6] * 2,                                  # ladder steps
])
def test_consensus_matches_cpu(seqs, dev):
    """The RNAalifold consensus on the card agrees with its CPU run at the
    consensus tolerance (tests/test_torch_alifold.py)."""
    got = alifold.Alifold(0.0)
    want = alifold.Alifold(0.0)
    np.testing.assert_allclose(got.consensus(seqs, dev), want.consensus(seqs, "cpu"),
                               rtol=2e-4, atol=1e-6)
    assert [c["attempts"] for c in got.calls] == [c["attempts"] for c in want.calls]
