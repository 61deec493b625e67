"""The port's CUDA kernels on the card (marker `cuda`).

These need an NVIDIA GPU and nvcc, so they skip where
`torch.cuda.is_available()` is false.  On the card (which has no JAX, so
the JAX-importing tests/conftest.py is not loaded):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

They are the port's one check on the card: every kernel against its
plain version, and the end-to-end runs of `RUNS` against their
references and launch rules (`tests/card_checks.py`).  `chip_smoke.py`
times the kernels, holding each to its plain version at the shapes it
times, and reads each kernel's launches from the runs of `RUNS`.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from dafs_tpu_torch.ops import (
    alifold, alifold_cuda, contrafold, cuda_lib, dd_step_cuda, mccaskill, mccaskill_cuda,
    nussinov, nussinov_cuda, nw, nw_cuda, paircrf, paircrf_cuda, pairhmm, pairhmm_cuda,
)
from dafs_tpu_torch.ops import alifold_kernel as ak
from dafs_tpu_torch.utils import spans
from tests import card_checks
from tests.card_checks import PAIRHMM, RUNS

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
    (pairhmm_cuda, "FORWARD"), (pairhmm_cuda, "BACKWARD"), (pairhmm_cuda, "POSTERIOR"),
    (nussinov_cuda, "DECODE"), (nw_cuda, "DECODE"),
    (alifold_cuda, "INSIDE"), (alifold_cuda, "EXTERIOR"), (alifold_cuda, "OUTSIDE"),
    (mccaskill_cuda, "INSIDE"), (mccaskill_cuda, "EXTERIOR"), (mccaskill_cuda, "OUTSIDE"),
    (dd_step_cuda, "CANDIDATES"), (dd_step_cuda, "UPDATE"), (dd_step_cuda, "SCALARS"),
    (paircrf_cuda, "FORWARD"), (paircrf_cuda, "BACKWARD"), (paircrf_cuda, "POSTERIOR"),
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
            run = {"FORWARD": pairhmm.forward, "BACKWARD": pairhmm.backward,
                   "POSTERIOR": pairhmm.forward_backward_posterior}[attr]
            run(*_pairhmm_args(dev, rng), pairhmm.tables(dev))
        elif module is nussinov_cuda:
            nussinov.decode(sm, lens)
        elif module is nw_cuda:
            nw.decode(*nw_args)
        elif module is mccaskill_cuda:
            mccaskill.batch_bp_posteriors_fast(["GGGGAAAACCCC", "GCGCUUCGGCGCAA"], 0.0, dev)
        elif module is dd_step_cuda:
            from dafs_tpu_torch import dd
            from tests.merge_problems import KW, PROBLEMS, _problem

            probs = [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS[2:4]]
            dd.solve_by_dd_batch(probs, device=dev, t_max=20, **KW)
        elif module is paircrf_cuda:
            paircrf.batch_posteriors(["GGGAAACCC", "GCGCAAUU"], ["GGAACC", "GCGAUUA"], 0.0, dev)
        else:
            alifold.Alifold(0.0).consensus(["GGGC-AAAGCCC", "GG-CAAA-GCCC"], dev)
    assert broken.launches == 0


def test_kernels_match_plain_versions(dev):
    rng = np.random.default_rng(1)
    args = _pairhmm_args(dev, rng)
    tab = pairhmm.tables(dev)
    fwd, bwd = pairhmm.forward_plain(*args, tab), pairhmm.backward_plain(*args, tab)
    post = pairhmm.posterior(*fwd, *bwd, args[1], args[3], tab)
    for got, want in ((pairhmm.forward(*args, tab), fwd), (pairhmm.backward(*args, tab), bwd),
                      ((pairhmm.forward_backward_posterior(*args, tab),), (post,)),
                      ((pairhmm_cuda.posterior(*fwd, *bwd, args[1], args[3], tab),), (post,))):
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
    tab = pairhmm.tables(dev)
    args = _pairhmm_args(dev, np.random.default_rng(2))
    with pytest.raises(ValueError, match="CUDA"):
        pairhmm_cuda.forward_backward_posterior(*(a.cpu() for a in args), pairhmm.tables("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        pairhmm_cuda.posterior(torch.zeros((1, 9, 9)), torch.zeros((1, 6)), torch.zeros((1, 9, 9)),
                               torch.zeros((1, 3)), *(torch.tensor([8], dtype=torch.int32),) * 2,
                               pairhmm.tables("cpu"))
    with pytest.raises(ValueError, match="int32"):
        pairhmm_cuda.forward_backward_posterior(args[0].long(), *args[1:], tab)
    fm, fcap = pairhmm_cuda.forward(*args, tab)
    with pytest.raises(ValueError, match="bcap"):
        pairhmm_cuda.posterior(fm, fcap, fm, fcap, args[1], args[3], tab)


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


def _snapshot_rows(name):
    with open(os.path.join(os.path.dirname(__file__), "snapshots", name)) as fh:
        return fh.read().splitlines()[4::2]


def _mutated(rows, k, rng):
    """k rows from `rows`, cycled, with a tenth of their bases changed
    (gaps kept): an alignment of k sequences at the rows' width."""
    out = []
    for r in range(k):
        row = np.array(list(rows[r % len(rows)]))
        hit = (row != "-") & (rng.random(len(row)) < 0.1)
        row[hit] = rng.choice(list("ACGU"), size=int(hit.sum()))
        out.append("".join(row))
    return out


def _tiled(rows, n):
    """The rows repeated side by side and cut to n columns."""
    return [(r * (n // len(r) + 1))[:n] for r in rows]


def _consensus_cases():
    rng = np.random.default_rng(10)
    r5, r17 = _snapshot_rows("rf00005_default_tpu.txt"), _snapshot_rows("rf00017_default_tpu.txt")
    return {
        "n 1056": (_tiled(r17, 1056), True, None, None),
        "n 1056, NS 2": (_tiled(r17[:2], 1056), True, None, None),
        "RF00005 final": (r5, True, None, None),
        "RF00005 final, Vienna": (r5, False, None, None),
        "RF00005 final, BCUT 8": (r5, True, None, 8),
        "RF00017 final": (r17, True, None, None),
        "NS 2": (r5[:2], True, None, None),
        "NS 3, constrained": (r5[3:6], True, "." * 10 + "((((x" + "." * 60 + "))))" + "." * 6,
                              None),
        "NS 50": (_mutated(r5, 50, rng), True, None, None),
        "NS 50, Vienna, BCUT 31": (_mutated(r5, 50, rng), False, None, 31),
    }


@pytest.mark.parametrize("case", [
    "RF00005 final", "RF00005 final, Vienna", "RF00005 final, BCUT 8", "RF00017 final", "NS 2",
    "NS 3, constrained", "NS 50", "NS 50, Vienna, BCUT 31", "n 1056", "n 1056, NS 2",
])
def test_consensus_kernels_match_plain(case, dev):
    """The consensus kernels against the plain loops on the card, through
    the pf-scale ladder from its first scale (past n 520 from a scale with
    Q near 1): pout within the consensus tolerance (rtol 2e-4, atol 1e-6)
    and Q within rtol 2e-4, the same attempts and final scale; one launch
    a scan; two runs of the kernels bit-equal."""
    seqs, bl, con, bcut = _consensus_cases()[case]
    x = alifold._inputs(seqs, bl, con)
    n = x["n"]
    BCUT = alifold._bcut(x["S"], n) if bcut is None else bcut
    args = alifold.device_args(x, dev)
    # past n of about 520 one ladder step moves Q by more than the ladder's
    # window, so a long alignment starts from a scale with Q near 1
    sc0 = alifold.SC0 if n < 520 else card_checks.stable_scale(args, n, x["bsn0"], BCUT)
    want = alifold.partition(args, n, x["bsn0"], sc0, BCUT, ak.inside_outside)
    got = alifold.partition(args, n, x["bsn0"], sc0, BCUT, alifold_cuda.call_loops())
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)
    assert got[2:] == want[2:]
    p = ak.prepare(*args, n, got[2], x["bsn0"])
    before = [k.launches for k in (alifold_cuda.INSIDE, alifold_cuda.EXTERIOR,
                                   alifold_cuda.OUTSIDE)]
    first = [t.clone() for t in alifold_cuda.inside_outside(p, n, BCUT=BCUT)]
    assert [k.launches - b for k, b in zip((alifold_cuda.INSIDE, alifold_cuda.EXTERIOR,
                                            alifold_cuda.OUTSIDE), before)] == [1, 1, 1]
    _equal(alifold_cuda.inside_outside(p, n, BCUT=BCUT), first)


@pytest.mark.parametrize("case", ["RF00005 final", "NS 3, constrained", "NS 50"])
def test_consensus_ladder_from_an_overflowing_scale(case, dev):
    """From a scale at which Q overflows float32, the kernels and the plain
    loops take the ladder through the same attempts: each attempt's scale,
    and whether Q and pout are finite, are the same."""
    seqs, bl, con, bcut = _consensus_cases()[case]
    x = alifold._inputs(seqs, bl, con)
    n = x["n"]
    BCUT = alifold._bcut(x["S"], n) if bcut is None else bcut
    args = alifold.device_args(x, dev)
    _, Q0, sc0, _ = alifold.partition(args, n, x["bsn0"], alifold.SC0, BCUT, ak.inside_outside)
    start = np.float32(sc0 * np.float32((1e39 / Q0) ** (1.0 / n)))   # Q scales as sc ** n
    runs = []
    for loops in (ak.inside_outside, alifold_cuda.inside_outside):
        trace = []

        def run(p, n, BCUT, loops=loops, trace=trace):
            pout, Q = loops(p, n, BCUT=BCUT)
            trace.append((float(p["sc_t"]), bool(torch.isfinite(Q)),
                          bool(torch.isfinite(pout).all())))
            return pout, Q

        runs.append((alifold.partition(args, n, x["bsn0"], start, BCUT, run), trace))
    (want, plain), (got, kern) = runs
    assert not plain[0][1] and len(plain) > 1 and kern == plain
    assert got[2:] == want[2:]
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["RF00005 final", "RF00017 final", "NS 50"])
def test_consensus_kernels_match_plain_steps(case, dev):
    """Each consensus kernel alone at the call's settled scale against its
    plain step on the card: qb, q1, qn and Q within rtol 2e-4 and a
    millionth of their largest value, pout within rtol 2e-4 / atol 1e-6;
    one launch, two runs bit-equal."""
    seqs, bl, _, _ = _consensus_cases()[case]
    card_checks.consensus_steps(dev, seqs, bl)


@pytest.mark.parametrize("NS,n", [(2, 1056), (10, 1056), (10, 2048)])
def test_consensus_past_rf00017_widths(NS, n, dev):
    """RF00017's rows tiled to n columns, from a scale with Q near 1: Q
    finite, pout in [0, 1 + 2e-4] (the consensus's rtol; it clips to [0,
    1]), two runs bit-equal; up to n 1056 an attempt at a scale where Q
    overflows is read alike by the kernels and the plain loops (Q not
    finite on both, pout finite on both or neither)."""
    seqs = _tiled(_snapshot_rows("rf00017_default_tpu.txt")[:NS], n)
    x = alifold._inputs(seqs, True, None)
    BCUT = alifold._bcut(x["S"], n)
    args = alifold.device_args(x, dev)
    sc = card_checks.stable_scale(args, n, x["bsn0"], BCUT)
    p = ak.prepare(*args, n, sc, x["bsn0"])
    pout, Q = [t.clone() for t in alifold_cuda.inside_outside(p, n, BCUT=BCUT)]
    _equal(alifold_cuda.inside_outside(p, n, BCUT=BCUT), (pout, Q))
    assert bool(torch.isfinite(Q)) and bool(torch.isfinite(pout).all())
    assert float(pout.min()) >= 0.0 and float(pout.max()) <= 1.0 + 2e-4
    if n <= 1056:
        over = ak.prepare(*args, n, np.float32(sc * np.float32((1e39 / float(Q)) ** (1.0 / n))),
                          x["bsn0"])
        read = [(bool(torch.isfinite(q)), bool(torch.isfinite(o).all()))
                for o, q in (alifold_cuda.inside_outside(over, n, BCUT=BCUT),
                             ak.inside_outside(over, n, BCUT=BCUT))]
        assert read[0] == read[1] and not read[0][0]


def test_alifold_wrapper_rejects_bad_inputs(dev):
    x = alifold._inputs(["GGGC-AAAGCCC", "GG-CAAA-GCCC"], True, None)
    args = alifold.device_args(x, "cpu")
    p = ak.prepare(*args, x["n"], np.float32(alifold.SC0), x["bsn0"])
    with pytest.raises(ValueError, match="CUDA"):
        alifold_cuda.inside_outside(p, x["n"])
    p = ak.prepare(*alifold.device_args(x, dev), x["n"], np.float32(alifold.SC0), x["bsn0"])
    pk = alifold_cuda.pack(p, x["n"], 31)
    bad = dict(pk, tensors=dict(pk["tensors"], hp=pk["tensors"]["hp"].double()))
    with pytest.raises(ValueError, match="float32"):
        alifold_cuda.launch_args(bad)
    bad = dict(pk, tensors=dict(pk["tensors"], a2sb=pk["tensors"]["a2sb"].int()))
    with pytest.raises(ValueError, match="int16"):
        alifold_cuda.launch_args(bad)
    bad = dict(pk, tensors=dict(pk["tensors"], pout=pk["tensors"]["pout"][:-1]))
    with pytest.raises(ValueError, match="pout"):
        alifold_cuda.launch_args(bad)
    bad = dict(pk, tensors=dict(pk["tensors"], ext=pk["tensors"]["ext"].t()))
    with pytest.raises(ValueError, match="contiguous"):
        alifold_cuda.launch_args(bad)


def _rna(rng, lens):
    return ["".join(rng.choice(list("ACGU"), size=n)) for n in lens]


def test_paircrf_matches_cpu(dev):
    """The CONTRAlign pair-CRF (plain PyTorch on every device) on the card
    against its CPU run, ragged and rectangular: within 1e-6, the bound it
    holds against `dafs_tpu` on the CPU (tests/test_torch_contra.py)."""
    rng = np.random.default_rng(2)
    s1, s2 = _rna(rng, (5, 31, 33, 70, 2)), _rna(rng, (64, 32, 9, 75, 1))
    for g, w in zip(paircrf.batch_posteriors(s1, s2, 0.0, dev),
                    paircrf.batch_posteriors(s1, s2, 0.0, "cpu")):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def _crf_equal(args):
    """The kernels' posteriors are the plain version's on the card, bit for
    bit; returns them."""
    tab = paircrf.tables(args[0].device)
    got = paircrf.forward_backward_posterior(*args, tab)
    want = paircrf.forward_backward_posterior_plain(*args, tab)
    assert got.shape == want.shape and torch.equal(got, want)
    return got


_CRF_CASES = ["ragged", "B 1", "length 1", "unknown bases", "bucket edges", "RF00005 all pairs"]


@pytest.mark.parametrize("case", _CRF_CASES)
def test_paircrf_kernels_match_plain(case, dev):
    """The three pair-CRF kernels against the plain version on the card:
    ragged batches with l1max != l2max, one pair, length-1 pairs, unknown
    bases (code 4), lengths at the 32-buckets' edges (32, 33, 96, 97) in
    one batch and each in its own bucket, RF00005's 45 pairs (L 96)."""
    rng = np.random.default_rng(_CRF_CASES.index(case) + 10)
    if case == "ragged":
        batches = [(_rna(rng, (5, 31, 33, 70, 2, 64, 96)), _rna(rng, (120, 32, 9, 75, 1, 40, 33)))]
    elif case == "B 1":
        batches = [(_rna(rng, (77,)), _rna(rng, (91,)))]
    elif case == "length 1":
        batches = [(_rna(rng, (1, 1, 50)), _rna(rng, (1, 50, 1)))]
    elif case == "unknown bases":
        alphabet = list("ACGUNTX")
        seqs = ["".join(rng.choice(alphabet, size=n)) for n in (40, 63, 17, 80)]
        batches = [(seqs, seqs[::-1])]
    elif case == "RF00005 all pairs":
        seqs = [f.seq for f in card_checks.read_fasta("RF00005_0.fa")]
        batches = [([a for k, a in enumerate(seqs) for _ in seqs[k + 1:]],
                    [b for k, _ in enumerate(seqs) for b in seqs[k + 1:]])]
    else:
        edges = (32, 33, 96, 97)
        batches = [(_rna(rng, edges), _rna(rng, edges[::-1]))]
        batches += [(_rna(rng, (n,)), _rna(rng, (n,))) for n in edges]
    for s1, s2 in batches:
        _crf_equal(card_checks.paircrf_inputs(s1, s2, dev))


def test_paircrf_largest_contra_batch(dev):
    """contra-trna's largest batch: the 105 pairs of its 15-sequence family
    (mutated RF00005 members, L 96), bit-equal, one launch of each kernel,
    and the span counts `kernel_batches` 1."""
    from dafs_tpu_torch.utils import spans
    from portbench import traffic

    pool = traffic.Families(traffic.load_mix("trna11"), 2217000001).pool
    (fam,) = [[s for _, s in f] for f in pool if len(f) == 15]
    s1 = [a for k, a in enumerate(fam) for _ in fam[k + 1:]]
    s2 = [b for k, _ in enumerate(fam) for b in fam[k + 1:]]
    assert len(s1) == 105
    args = card_checks.paircrf_inputs(s1, s2, dev)
    assert args[0].shape[1] - 1 == 96 and args[2].shape[1] - 1 == 96
    _crf_equal(args)
    kernels = (paircrf_cuda.FORWARD, paircrf_cuda.BACKWARD, paircrf_cuda.POSTERIOR)
    before = [k.launches for k in kernels]
    with spans.record() as recs:
        paircrf.batch_posteriors(s1, s2, 0.01, dev)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    (sp,) = [r for r in recs if r.name == "paircrf.batch"]
    assert sp.counts["kernel_batches"] == 1 and sp.counts["diagonals"] == 2 * 193


@pytest.mark.parametrize("imax", [1025, 1500])
def test_paircrf_strip_variant_matches_plain(imax, dev):
    """Above 1024 rows the passes walk strips of 1024 rows (one launch
    each), bit-equal to the plain version."""
    rng = np.random.default_rng(imax)
    args = card_checks.paircrf_inputs(_rna(rng, (imax - 1, 700, 1)), _rna(rng, (40, 64, 9)), dev,
                                     l1max=imax - 1, l2max=64)
    kernels = (paircrf_cuda.FORWARD, paircrf_cuda.BACKWARD, paircrf_cuda.POSTERIOR)
    before = [k.launches for k in kernels]
    got = paircrf.forward_backward_posterior(*args, paircrf.tables(dev))
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    assert torch.equal(got, paircrf.forward_backward_posterior_plain(*args, paircrf.tables(dev)))


def test_paircrf_wrapper_rejects_bad_inputs(dev):
    """Above the ceiling of 4096 rows, above MAX_COLS columns, CPU tensors,
    codes that are not int32, and codes that are not contiguous: ValueError,
    nothing launched."""
    rng = np.random.default_rng(5)
    tab = paircrf.tables(dev)
    kernels = (paircrf_cuda.FORWARD, paircrf_cuda.BACKWARD, paircrf_cuda.POSTERIOR)
    before = [k.launches for k in kernels]
    over = card_checks.paircrf_inputs(["ACGU"], ["ACGU"], dev, l1max=paircrf_cuda.CEILING,
                                     l2max=32)
    for fn in (paircrf.forward_backward_posterior, paircrf_cuda.forward,
               paircrf_cuda.backward):
        with pytest.raises(ValueError, match="ceiling of 4096"):
            fn(*over, tab)
    wide = card_checks.paircrf_inputs(["ACGU"], ["ACGU"], dev, l1max=32,
                                     l2max=paircrf_cuda.MAX_COLS)
    with pytest.raises(ValueError, match="padded lengths"):
        paircrf_cuda.forward_backward_posterior(*wide, tab)
    args = card_checks.paircrf_inputs(_rna(rng, (20, 30)), _rna(rng, (25, 9)), dev)
    with pytest.raises(ValueError, match="CUDA"):
        paircrf_cuda.forward_backward_posterior(*(a.cpu() for a in args), paircrf.tables("cpu"))
    with pytest.raises(ValueError, match="int32"):
        paircrf_cuda.forward_backward_posterior(args[0].long(), *args[1:], tab)
    with pytest.raises(ValueError, match="int32"):
        paircrf_cuda.forward_backward_posterior(*args[:3], args[3].long(), tab)
    strided = torch.zeros((2, 2 * args[2].shape[1]), dtype=torch.int32, device=dev)[:, ::2]
    strided.copy_(args[2])
    with pytest.raises(ValueError, match="contiguous"):
        paircrf_cuda.forward_backward_posterior(*args[:2], strided, args[3], tab)
    with pytest.raises(ValueError, match="float32"):
        paircrf_cuda.forward_backward_posterior(*args, {**tab, "pair": tab["pair"].double()})
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("constrained", [False, True])
def test_contrafold_matches_cpu(constrained, dev):
    """CONTRAfold (plain PyTorch on every device) on the card against its
    CPU run over two buckets: within 1e-5, its bound against `dafs_tpu`."""
    rng = np.random.default_rng(3)
    seqs = _rna(rng, (20, 31, 45, 73))
    cons = None
    if constrained:
        cons = ["(" + "?" * 3 + "." + "?" * (len(s) - 6) + ")" for s in seqs]
    got = contrafold.batch_bp_posteriors(seqs, 0.0, dev, constraints=cons)
    want = contrafold.batch_bp_posteriors(seqs, 0.0, "cpu", constraints=cons)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def _contrafold_replay(seqs, cons, dev):
    """One bucket through `contrafold.batch_bp_posteriors` on the card:
    (its graph's posteriors cut to the bucket's B rows, the eager
    `inside_outside` on the unpadded batch, the bucket's span)."""
    B, L = len(seqs), -(-max(map(len, seqs)) // 32) * 32
    card = torch.device("cuda", torch.cuda.current_device())
    with spans.record() as recs:
        contrafold.batch_bp_posteriors(seqs, 0.0, dev, constraints=cons)
    (sp,) = [r for r in recs if r.name == "contrafold.batch"]
    got = contrafold._GRAPHS[card, sp.attrs["Bp"], L].post[:B]
    arrays = contrafold._bucket_arrays(seqs, cons or [None] * B, L, B)
    want = contrafold.inside_outside(*(torch.from_numpy(a).to(dev) for a in arrays),
                                     contrafold.tables(dev))
    torch.cuda.synchronize()
    return got, want, sp


@pytest.mark.parametrize("L", [32, 96, 128, 320])
@pytest.mark.parametrize("B", [1, 5, 15, 16, 17, 50])
def test_contrafold_graph_matches_eager(B, L, dev):
    """A bucket of B sequences (lengths across the bucket, its longest L)
    replays the graph of (`_graph_rows(B, L)`, L): its posteriors equal the
    eager `inside_outside` on the unpadded batch bit for bit, the same
    kernels as the plain run (and the check's frozen copy) launches."""
    rng = np.random.default_rng(1000 * B + L)
    seqs = _rna(rng, [L] + list(rng.integers(max(L - 31, 1), L + 1, size=B - 1)))
    got, want, sp = _contrafold_replay(seqs, None, dev)
    assert sp.attrs["B"] == B and sp.attrs["Bp"] == contrafold._graph_rows(B, L)
    assert sp.counts["graph_replays"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["RF00005 constrained", "ragged", "B 5 at L 544",
                                  "B 9 at L 544"])
def test_contrafold_graph_matches_eager_cases(case, dev):
    """RF00005 under path (b)'s constraints from its SS_cons, one ragged
    bucket of L 96 (lengths 65 to 96), and buckets of L 544, whose rows are
    padded within their power-of-two class (7, 15): the replay equals the
    eager run bit for bit."""
    rng = np.random.default_rng(7)
    if case == "ragged":
        seqs, cons = _rna(rng, (65, 66, 71, 80, 88, 95, 96)), None
    elif case.endswith("544"):
        B = int(case.split()[1])
        seqs, cons = _rna(rng, [544] + list(rng.integers(513, 545, size=B - 1))), None
    else:
        seqs, cons = card_checks.refold_constraints("rf00005_default_tpu.txt")
    got, want, _ = _contrafold_replay(seqs, cons, dev)
    assert torch.equal(got, want)


def test_contrafold_graph_captured_once_a_shape(dev):
    """The first bucket of a shape captures its graph, the next replays it
    and captures nothing; both give the eager run's posteriors."""
    seqs = _rna(np.random.default_rng(11), (40, 50, 61))
    card = torch.device("cuda", torch.cuda.current_device())
    contrafold._GRAPHS.pop((card, contrafold._graph_rows(3, 64), 64), None)
    for captures in (1, 0):
        got, want, sp = _contrafold_replay(seqs, None, dev)
        assert (sp.counts["graph_captures"], sp.counts["graph_replays"]) == (captures, 1)
        assert torch.equal(got, want)


def _nussinov_stress(dev, rng, B, L, short):
    """Quarter-step scores, half the zeros -0.0 (frequent exact ties), and
    ragged lengths, the last `short` of them 0, 1, 2, ..."""
    sm = torch.from_numpy(card_checks.quarter_steps(rng, (B, L, L))).to(dev)
    return sm, torch.from_numpy(card_checks.ragged_lens(rng, B, L, short)).to(dev)


def _nw_stress(dev, rng, B, L1, L2, short):
    return card_checks.nw_inputs(rng, B, L1, L2, dev, short, ties=True)


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,L,short", [
    (8, 352, 2),    # tie-heavy, two problems of length 0 and 1
    (10, 320, 6),   # a DD layer of five merges, lengths 0..5 among them
    (1, 96, 0),     # one problem
    (2, 512, 1),    # tables on chip, codes in global memory
    (40, 352, 0),   # two CTAs a problem: tables in global memory
])
def test_nussinov_stress_matches_plain(B, L, short, dev):
    sm, lens = _nussinov_stress(dev, np.random.default_rng(B * 1000 + L), B, L, short)
    _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))


@pytest.mark.parametrize("B,L1,L2,short", [
    (4, 320, 320, 1), (5, 352, 320, 2), (1, 96, 96, 0), (2, 320, 321, 0),
])
def test_nw_stress_matches_plain(B, L1, L2, short, dev):
    args = _nw_stress(dev, np.random.default_rng(B * 1000 + L1 + L2), B, L1, L2, short)
    _equal(nw.decode(*args), nw.decode_plain(*args))


def _random_pairs(dev, rng, lens1, lens2, l1max, l2max):
    return card_checks.random_pairs(rng, lens1, lens2, l1max, l2max, dev)


def _pairhmm_equal(args, tab):
    fwd, bwd = pairhmm.forward_plain(*args, tab), pairhmm.backward_plain(*args, tab)
    _equal(pairhmm_cuda.forward(*args, tab), fwd)
    _equal(pairhmm_cuda.backward(*args, tab), bwd)
    _equal((pairhmm_cuda.forward_backward_posterior(*args, tab),),
           (pairhmm.posterior(*fwd, *bwd, args[1], args[3], tab),))


@pytest.mark.parametrize("case", ["ragged", "96x320", "320x96", "one pair"])
def test_pairhmm_stress_matches_plain(case, dev):
    """True lengths around a warp's 32 rows (and 0) in one batch, more
    columns than rows and the reverse, one pair: bit-equal passes and
    posteriors."""
    rng = np.random.default_rng(["ragged", "96x320", "320x96", "one pair"].index(case))
    n = rng.integers
    args = {
        "ragged": lambda: _random_pairs(dev, rng, [1, 2, 31, 32, 33, 64, 0, 64],
                                        [64, 33, 32, 31, 2, 1, 9, 64], 64, 64),
        "96x320": lambda: _random_pairs(dev, rng, n(60, 97, 6), n(200, 321, 6), 96, 320),
        "320x96": lambda: _random_pairs(dev, rng, n(200, 321, 6), n(60, 97, 6), 320, 96),
        "one pair": lambda: _random_pairs(dev, rng, [77], [91], 96, 96),
    }[case]()
    _pairhmm_equal(args, pairhmm.tables(dev))


@pytest.mark.parametrize("family", ["RF00005_0.fa", "RF00017_4.fa"])
def test_pairhmm_main_path_shapes(family, dev):
    """A family's all pairs (B 45; L <= 96, L <= 320): the passes, the
    posterior kernel on their outputs and codes to posteriors bit-equal to
    the plain versions."""
    args = card_checks.pairhmm_inputs(card_checks.read_fasta(family), dev)
    tab = pairhmm.tables(dev)
    _pairhmm_equal(args, tab)
    fwd, bwd = pairhmm_cuda.forward(*args, tab), pairhmm_cuda.backward(*args, tab)
    _equal((pairhmm_cuda.posterior(*fwd, *bwd, args[1], args[3], tab),),
           (pairhmm.posterior(*fwd, *bwd, args[1], args[3], tab),))


def test_pairhmm_fifty_sequence_family(dev):
    """1225 pairs at L <= 96: several waves of blocks."""
    rng = np.random.default_rng(50)
    args = _random_pairs(dev, rng, rng.integers(60, 97, 1225), rng.integers(60, 97, 1225), 96, 96)
    _pairhmm_equal(args, pairhmm.tables(dev))


def test_pairhmm_largest_rows_and_just_above(dev):
    """K1/K2 take up to MAX_IMAX rows (32 warps of a block); one row more
    goes to their long variants, bit-equal too, up to CEILING rows; above
    that, and above MAX_COLS columns, the wrappers raise."""
    rng = np.random.default_rng(4)
    tab = pairhmm.tables(dev)
    L = pairhmm_cuda.MAX_IMAX - 1
    _pairhmm_equal(_random_pairs(dev, rng, [L, 700], [40, 64], L, 64), tab)
    before = pairhmm_cuda.FORWARD_LONG.launches
    _pairhmm_equal(_random_pairs(dev, rng, [L + 1, 1000, 0], [40, 64, 9], L + 1, 64), tab)
    assert pairhmm_cuda.FORWARD_LONG.launches > before
    over = _random_pairs(dev, rng, [5], [5], pairhmm_cuda.CEILING, 64)
    with pytest.raises(ValueError, match="ceiling of 4096"):
        pairhmm_cuda.forward(*over, tab)
    with pytest.raises(ValueError, match="ceiling of 4096"):
        pairhmm_cuda.forward_backward_posterior(*over, tab)
    wide = _random_pairs(dev, rng, [5], [5], 32, pairhmm_cuda.MAX_COLS)
    with pytest.raises(ValueError, match="padded lengths"):
        pairhmm_cuda.backward(*wide, tab)


def test_largest_shapes_and_just_above(dev):
    """K3 takes L up to 1024 (tables and codes in global memory there); K4
    takes L2 + 1 <= 1024 columns and L1 rows while its shared memory fits
    (771 rows at 1023 columns).  One step above either goes to the long
    variant, bit-equal; above 4096 the wrappers raise naming the ceiling."""
    rng = np.random.default_rng(3)
    sm, lens = _nussinov_stress(dev, rng, 1, nussinov_cuda.MAX_L, 0)
    _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))
    over = nussinov_cuda.MAX_L + 32
    sm, lens = _nussinov_stress(dev, rng, 2, over, 1)
    _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))
    with pytest.raises(ValueError, match="ceiling of 4096"):
        nussinov_cuda.decode(torch.zeros((1, 4097, 4097), device=dev),
                             torch.tensor([5], dtype=torch.int32, device=dev))
    L2 = nw_cuda.MAX_COLS - 1
    L1 = max(n for n in range(1, 2000)
             if nw_cuda.smem_bytes(n, L2) <= nw_cuda.MAX_SMEM_BYTES)
    args = _nw_stress(dev, rng, 1, L1, L2, 0)
    _equal(nw.decode(*args), nw.decode_plain(*args))
    for shape in ((L1 + 1, L2), (64, L2 + 1), (1056, 1056)):
        assert nw_cuda.is_long(*shape)
        args = _nw_stress(dev, rng, 2, *shape, 1)
        _equal(nw.decode(*args), nw.decode_plain(*args))
    with pytest.raises(ValueError, match="ceiling of 4096"):
        nw_cuda.decode(torch.zeros((1, 8, 4097), device=dev),
                       *(torch.zeros((1, 9), dtype=torch.int32, device=dev),) * 2,
                       torch.tensor([1], dtype=torch.int32, device=dev),
                       torch.tensor([1], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("L", [1056, 2048])
def test_long_variants_match_plain(L, dev):
    """Each long variant past its kernel's old limit, bit-equal to its plain
    version: K1/K2 and the posteriors at imax = L rows (B = 2), K3 at
    padded L (B = 1 and 2), K4 at L x L."""
    rng = np.random.default_rng(L)
    _pairhmm_equal(_random_pairs(dev, rng, [L - 1, L - 40], [L - 9, L - 1], L - 1, L - 1),
                   pairhmm.tables(dev))
    for B in (1, 2):
        sm, lens = _nussinov_stress(dev, rng, B, L, 0)
        _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))
    args = _nw_stress(dev, rng, 2, L, L, 0)
    _equal(nw.decode(*args), nw.decode_plain(*args))


# (B, L, short): the main path's padded lengths (RF00005's merges,
# RF00017's merges and its 383-column final structure), DD layers' batches
# with ragged lengths down to 0, tables and codes in global memory
_NUSSINOV_SHAPES = [(8, 96, 0), (8, 352, 0), (8, 384, 0), (2, 320, 1), (4, 320, 2), (10, 320, 5),
                    (2, 352, 2), (4, 352, 4), (10, 352, 6), (1, 700, 0)]
# (B, L1, L2, short, ties): square merges, RF00017's last (352 x 320), DD
# layers' batches, and past K4's shared memory (the long variant)
_NW_SHAPES = [(4, 96, 96, 0, False), (4, 320, 320, 0, False), (4, 352, 320, 0, False),
              (1, 320, 320, 0, False), (2, 320, 320, 1, False), (5, 320, 320, 2, False),
              (1, 352, 320, 0, False), (2, 352, 320, 0, False), (5, 352, 320, 0, False),
              (2, 800, 992, 0, False), (2, 800, 992, 0, True)]


@pytest.mark.parametrize("B,L,short", _NUSSINOV_SHAPES)
def test_nussinov_main_path_shapes(B, L, short, dev):
    """K3 on scores shaped like the DD loop's (stems above a negative
    floor), bit-equal to the plain version."""
    sm, lens = card_checks.nussinov_inputs(np.random.default_rng(B * 1000 + L), B, L, dev, short)
    _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))


@pytest.mark.parametrize("B,L1,L2,short,ties", _NW_SHAPES)
def test_nw_main_path_shapes(B, L1, L2, short, ties, dev):
    """K4 on banded problems shaped like the DD loop's (and, with ties,
    quarter steps and -0.0), bit-equal to the plain version; only 800 x
    992 goes to the long variant."""
    args = card_checks.nw_inputs(np.random.default_rng(B * 1000 + L1 + L2), B, L1, L2, dev,
                                short, ties)
    assert nw_cuda.is_long(L1, L2) == (L1 == 800)
    _equal(nw.decode(*args), nw.decode_plain(*args))


def test_kernels_at_the_ceiling_are_well_formed(dev):
    """At the ceiling of 4096 (B 2): the pair-HMM posteriors finite within
    [-1e-5, 1]; K3's scores finite and its structures nested within the
    true lengths; K4's scores finite and its alignments increasing within
    them."""
    rng = np.random.default_rng(6)
    C = 4096
    args = card_checks.random_pairs(rng, [C - 1, C - 300], [C - 1, C - 77], C - 1, C - 1, dev)
    post = pairhmm.forward_backward_posterior(*args, pairhmm.tables(dev))
    assert bool(torch.isfinite(post).all())
    assert float(post.min()) >= -1e-5 and float(post.max()) <= 1.0
    sm, lens = card_checks.nussinov_inputs(rng, 2, C, dev)
    score, ss = nussinov_cuda.decode(sm, lens)
    assert bool(torch.isfinite(score).all())
    assert all(card_checks.valid_structure(ss[b].cpu().numpy(), int(lens[b])) for b in range(2))
    args = card_checks.nw_inputs(rng, 2, C, C, dev)
    score, al = nw_cuda.decode(*args)
    assert bool(torch.isfinite(score).all())
    assert all(card_checks.valid_alignment(al[b].cpu().numpy(), int(args[3][b]), int(args[4][b]))
               for b in range(2))


def test_host_dd_matches_cpu(dev):
    """The host-loop DD on the card (K3 and K4 every iteration) equals its
    CPU run (the plain decoders) on random problems, under both structure
    decoders."""
    from dafs_tpu_torch import dd
    from tests.merge_problems import KW, PROBLEMS, _problem

    for problem in PROBLEMS:
        p_x, p_y, p_z = _problem(*problem[:3])
        for decoder in ("nussinov", "ipknot"):
            runs = []
            for device in (dev, "cpu"):
                trace = []
                out = dd.solve_by_dd_ipknot(p_x, p_y, p_z, *problem[3:], device=device,
                                            t_max=80, structure_decoder=decoder,
                                            trace_cb=lambda *a, trace=trace: trace.append(a),
                                            **KW)
                runs.append((out, trace))
            (got, got_tr), (want, want_tr) = runs
            assert got[0] == want[0] and got_tr == want_tr
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g, w)


def test_rf00017_frozen_replay(dev):
    """The RF00017 frozen replay through the host-loop DD with K3 and K4:
    the tree line, SS_cons and every row equal the frozen output; K4
    launched once an iteration, K3 once more."""
    card_checks.replay_rf00017(dev)


@pytest.mark.parametrize("rule", ["subgradient", "adagrad", "adam"])
def test_dd_update_rules_match_cpu(rule, dev):
    """The batched DD under each update rule on the card (K3 and K4 every
    iteration) against its CPU run: the same iterations, violations and
    (x, y, z), and s within four float32 ulps.  The steps are separate IEEE
    float32 ops on both, sqrt and division rounded; s adds the active
    candidates' multipliers in one `torch.sum`, which the card reduces in
    another order than the CPU (one ulp apart under adam, measured)."""
    from dafs_tpu_torch import dd
    from tests.merge_problems import KW, PROBLEMS, _problem

    probs = [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS]
    runs = []
    for device in (dev, "cpu"):
        stats = []
        out = dd.solve_by_dd_batch(probs, device=device, t_max=200, update_rule=rule,
                                   stats=stats, **KW)
        runs.append((out, stats))
    (got, got_st), (want, want_st) = runs
    assert got_st == want_st
    for g, w in zip(got, want):
        assert abs(g[0] - w[0]) <= 4 * 2.0 ** -23 * abs(w[0])
        for u, v in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(u, v)


def _dd_batch(batch):
    from tests.merge_problems import DENSE, PROBLEMS, _dense_problem, _problem

    if batch == "problems":  # merges converging after 1 to 116 bodies, one capped
        return [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS], 120
    if batch == "dense":  # P1 96, P2 64, U 1280
        return [(*_dense_problem(*p[:3]), *p[3:]) for p in DENSE], 40
    # padded 1056 and 64: K3's long variant (past MAX_L)
    return [(*_problem(11, 1040, 60), 2, 1), (*_problem(12, 700, 50), 1, 1)], 4


@pytest.mark.parametrize("rule", ["subgradient", "adagrad", "adam"])
@pytest.mark.parametrize("batch", ["problems", "dense", "long"])
def test_dd_step_kernels_match_plain_step(batch, rule, dev):
    """The DD step kernels against the plain step on the card, body by
    body: q, the optimiser state, eta, c, s, t, violated, x, y, z and done
    bit-equal after every body, and the kernels' score matrices for the
    next body the plain ones; with merges freezing on the way, P1 != P2, U
    above 256, and a padded length above K3's MAX_L."""
    from tests.merge_problems import KW

    probs, bodies = _dd_batch(batch)
    if batch == "long":
        assert -(-max(p[2].shape[0] for p in probs) // 32) * 32 > nussinov_cuda.MAX_L
    done = card_checks.compare_dd_bodies(probs, dict(KW, device=dev, t_max=600), rule, bodies)
    if batch == "problems" and rule == "subgradient":
        assert 0 < done < len(probs)


@pytest.fixture(scope="module")
def card_dd_layers():
    """Every batched DD layer of RF00005's and family-50's default runs on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    return {"RF00005": card_checks.dd_layers(card_checks.read_fasta("RF00005_0.fa"), dev),
            "family-50": card_checks.dd_layers(card_checks.family50(), dev)}


@pytest.mark.parametrize("rule", ["subgradient", "adagrad", "adam"])
@pytest.mark.parametrize("family", ["RF00005", "family-50"])
def test_dd_kernel_route_matches_plain_route(family, rule, card_dd_layers):
    """`solve_by_dd_batch` through the step kernels equals it through the
    plain step on the card, bit for bit in (s, x, y, z) and the iterations
    and violations of every merge, on every layer of the family; and 40
    loop bodies through both leave bit-equal states (`compare_dd_bodies`)
    on RF00005's layers and family-50's first and last."""
    layers = card_dd_layers[family]
    assert len(layers) >= (3 if family == "RF00005" else 6)
    for problems, kw in layers:
        got, want = card_checks.solve_both_routes(problems, kw, rule)
        assert card_checks.dd_solutions_equal(got, want), (family, rule, len(problems))
    for problems, kw in layers if family == "RF00005" else (layers[0], layers[-1]):
        card_checks.compare_dd_bodies(problems, kw, rule, 40)


def test_dd_step_counts_its_bodies(dev):
    """On the card every DD loop body goes through the step kernels: the
    counter step_kernel_bodies equals iterations, and each step kernel
    launches once a body; through the plain step both are 0."""
    from dafs_tpu_torch import dd
    from dafs_tpu_torch.utils import spans
    from tests.merge_problems import KW, PROBLEMS, _problem

    probs = [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS]
    for plain in (False, True):
        before = {n: k.launches for n, k in card_checks.kernels().items()}
        with spans.record() as recs:
            if plain:
                with card_checks.plain_dd_step():
                    dd.solve_by_dd_batch(probs, device=dev, t_max=150, **KW)
            else:
                dd.solve_by_dd_batch(probs, device=dev, t_max=150, **KW)
        (loop,) = [sp for sp in recs if sp.name == "dd.loop"]
        assert loop.counts["iterations"] > 0
        bodies = 0 if plain else loop.counts["iterations"]
        assert loop.counts["step_kernel_bodies"] == bodies
        assert {n: card_checks.kernels()[n].launches - before[n]
                for n in card_checks.DD_STEP} == dict.fromkeys(card_checks.DD_STEP, bodies)


def test_dd_step_wrapper_rejects_bad_inputs(dev):
    """The step kernels' wrapper raises on a wrong dtype, shape or device,
    of a decode's output or of the state, and launches nothing."""
    from tests.merge_problems import KW, PROBLEMS, _problem

    probs = [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS[:3]]
    pr, st = card_checks.dd_state(probs, dict(KW, device=dev, t_max=50), "adam")
    step_kernels = [card_checks.kernels()[n] for n in card_checks.DD_STEP]
    B, P, P1 = st.B, max(st.P1, st.P2), st.P1
    s_xy = torch.zeros(2 * B, device=dev)
    xy = torch.zeros((2 * B, P), dtype=torch.int32, device=dev)
    s_z = torch.zeros(B, device=dev)
    z_new = torch.zeros((B, P1), dtype=torch.int32, device=dev)
    before = [k.launches for k in step_kernels]
    for bad in ((s_xy.double(), xy, s_z, z_new), (s_xy, xy[:, 1:].contiguous(), s_z, z_new),
                (s_xy, xy, s_z.cpu(), z_new), (s_xy, xy, s_z, z_new.long()),
                (s_xy, torch.zeros((P, 2 * B), dtype=torch.int32, device=dev).t(), s_z, z_new)):
        with pytest.raises(ValueError):
            st.kernels(*bad)
    with pytest.raises(ValueError):
        dd_step_cuda.Step(dict(pr, p_x=pr["p_x"].double()), st)
    with pytest.raises(ValueError):
        dd_step_cuda.Step(dict(pr, cbp=pr["cbp"].int()), st)
    st.opt = st.opt[:3]
    with pytest.raises(ValueError):
        dd_step_cuda.Step(pr, st)
    st.q_x = st.q_x.cpu()
    with pytest.raises(ValueError):
        dd_step_cuda.Step(pr, st)
    assert before == [k.launches for k in step_kernels]


def test_fourway_matches_cpu(dev):
    """Four-way PCT on the card (cuBLAS) against its CPU run, 1e-6."""
    from dafs_tpu_torch import consistency
    from tests.merge_problems import _helix_probs

    rng = np.random.default_rng(7)
    lens = [70, 75, 82, 64]
    L, N = max(lens), len(lens)
    bp = np.zeros((N, L, L), np.float32)
    mp = np.zeros((N, N, L, L), np.float32)
    for x, lx in enumerate(lens):
        bp[x, :lx, :lx] = _helix_probs(rng, lx, 5)
        mp[x, x][np.arange(lx), np.arange(lx)] = 1.0
        for y in range(x + 1, N):
            ly = lens[y]
            band = np.abs(np.arange(lx)[:, None] * ly / lx - np.arange(ly)[None, :]) < 3
            m = np.float32(band * rng.random((lx, ly)))
            mp[x, y, :lx, :ly], mp[y, x, :ly, :lx] = m, m.T
    got = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, dev)
    want = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, "cpu")
    assert float(np.abs(got.astype(np.float64) - want).max()) <= 1e-6


def test_fourway_on_rf00005_posteriors_matches_cpu(dev):
    """Four-way PCT on RF00005's own posteriors (45 pairs, L 96): the card
    against its CPU run, 1e-6."""
    from dafs_tpu_torch import consistency
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.typedefs import CUTOFF

    fa = card_checks.read_fasta("RF00005_0.fa")
    lens = [len(f) for f in fa]
    bp = fold_models.by_name("Boltzmann", CUTOFF).all_seqs(fa, dev)
    mp = align_models.by_name("ProbCons", 0.01).all_pairs(fa, dev)
    got = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, dev)
    want = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, "cpu")
    assert float(np.abs(got.astype(np.float64) - want).max()) <= 1e-6


def test_decoders_on_last_card_match_plain(dev):
    """K3 and K4 launch on their tensors' card: on the last visible card
    (not the current one) each is bit-equal to its plain version there.
    Needs two or more cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() != last.index
    rng = np.random.default_rng(11)
    sm, lens = _nussinov_stress(last, rng, 8, 352, 2)
    _equal(nussinov.decode(sm, lens), nussinov.decode_plain(sm, lens))
    args = _nw_stress(last, rng, 4, 320, 320, 1)
    _equal(nw.decode(*args), nw.decode_plain(*args))
    torch.cuda.synchronize(last)


def test_sharded_stages_match_unsharded(dev):
    """The fold (its posteriors and the thresholded bp), all-pairs, the
    similarity, both PCTs and the guide tree of RF00005 and of the
    50-sequence family of `bench.py` on a two-shard mesh of this card (and
    across the cards where there are several) equal the single-device run
    bit for bit; the sharded runs launch the pair-HMM kernels and each fold
    kernel once a ladder attempt of a bucket shard."""
    from dafs_tpu_torch import consistency, guide_tree
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.parallel import mesh

    def stages(fa):
        lens = [len(f.seq) for f in fa]
        fold = fold_models.RNAfold(True, 1e-4)
        posts = fold.batch_bp_posteriors([f.seq for f in fa], dev, th=0.0)
        bp = fold.all_seqs(fa, dev, posts)
        mp = align_models.ProbCons(0.01).all_pairs(fa, dev)
        sim = consistency.similarity_matrix(mp, lens, dev)
        return [*posts, bp, mp, sim,
                consistency.relax_basepairing_probability(bp, mp, sim, lens, 0.25, dev),
                consistency.relax_matching_probability(mp, sim, lens, 0.25, dev),
                guide_tree.print_tree(guide_tree.build_tree(sim), [f.name for f in fa])]

    for fa in (card_checks.read_fasta("RF00005_0.fa"), card_checks.family50()):
        with mesh.force_single_device():
            want = stages(fa)
        for shards in ({2} | {torch.cuda.device_count()}) - {1}:
            with card_checks.Launches() as n, mesh.virtual_mesh(shards):
                got = stages(fa)
            n.hold(launched=PAIRHMM)
            assert got[-1] == want[-1]
            for g, w in zip(got[:-1], want[:-1]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("family,shards", [
    ("RF00005", 25), ("RF00005", 7), ("RF00017_4", 3), ("RF00017_4", 10),
])
def test_fold_rows_do_not_depend_on_the_batch(family, shards, dev):
    """McCaskill on the card gives each sequence the same bits in a batch
    of any size: the 50-sequence family of `bench.py` (built from RF00005)
    and RF00017, split over `shards` shards of one card, against one batch
    (cuBLAS and PyTorch's reduce order by shape; `ops/mccaskill_kernel`)."""
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.models import fold_models
    from dafs_tpu_torch.parallel import dryrun, mesh

    seqs = [f.seq for f in load_fasta(f"tests/data/{family}_0.fa" if family == "RF00005"
                                      else f"tests/data/{family}.fa")]
    if family == "RF00005":
        seqs = dryrun.mutated_family(seqs)
    fold = fold_models.RNAfold(True, 0.0)
    with mesh.force_single_device():
        want = fold.batch_bp_posteriors(seqs, dev)
    with mesh.virtual_mesh(shards):
        got = fold.batch_bp_posteriors(seqs, torch.device("cuda", 0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _fold_cases():
    r5 = [f.seq for f in card_checks.read_fasta("RF00005_0.fa")]
    r17 = [f.seq for f in card_checks.read_fasta("RF00017_4.fa")]
    con_seqs, cons = card_checks.refold_constraints("rf00005_default_tpu.txt")
    rows17 = card_checks.read_snapshot("rf00017_default_tpu.txt")[3]
    return {
        "RF00005": dict(seqs=r5), "RF00017": dict(seqs=r17), "B 1": dict(seqs=r5[:1]),
        "constrained": dict(seqs=con_seqs, cons=cons), "Vienna": dict(seqs=r5[:4], bl=False),
        "overflowing start": dict(seqs=r5[:3], start="over"),
        "n 1056": dict(seqs=[(r.replace("-", "") * 4)[:1056] for r in rows17[:2]],
                       start="stable"),
        "family-50": dict(seqs=[f.seq for f in card_checks.family50()]),
    }


@pytest.mark.parametrize("case", ["RF00005", "RF00017", "B 1", "constrained", "Vienna",
                                  "overflowing start", "n 1056", "family-50"])
def test_fold_kernels_match_plain(case, dev):
    """The fold kernels against the plain McCaskill on the card, through the
    pf-scale ladder (`card_checks.fold_case`): the same attempts and
    readings, pout within rtol 2e-4 / atol 1e-6 and Q within rtol 2e-4,
    each kernel against the plain step, one launch a kernel an attempt, two
    runs bit-equal."""
    card_checks.fold_case(dev, **_fold_cases()[case])


def test_fold_at_n_2048_is_well_formed(dev):
    """Two of RF00017's sequences tiled to n 2048, from scales with Q near
    1, through the kernels: Q and the posteriors finite, pout in [0, 1 +
    2e-4], the attempt bit-equal across two runs."""
    rows17 = card_checks.read_snapshot("rf00017_default_tpu.txt")[3]
    seqs = [(r.replace("-", "") * 8)[:2048] for r in rows17[:2]]
    last = card_checks.traced_fold(seqs, dev, True, None, card_checks.fold_stable_scale(seqs, dev),
                                  plain=False)[2]
    pout, Q = last["pout"], last["Q"]
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(pout).all())
    assert float(pout.min()) >= 0.0 and float(pout.max()) <= 1.0 + 2e-4
    first = [x.clone() for x in mccaskill_cuda.mccaskill(last["prep"], last["sc"])]
    _equal(mccaskill_cuda.mccaskill(last["prep"], last["sc"]), first)


def test_fold_wrapper_rejects_bad_inputs(dev):
    """A CPU bucket, a dtype, a shape, a layout or a device that the kernels
    do not take raises; so do CUDA tensors without the bucket's prepare."""
    from dafs_tpu_torch import params

    t = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    S, PT, AP, AU, ns = mccaskill.bucket_inputs(["GGGGAAAACCCC", "GCGCUUCGGCGCAA"], 32, 2)

    def prep_on(d):
        return mccaskill_cuda.prepare(t(S, d), t(PT, d), t(AP, d), t(AU, d), t(ns, d),
                                      mccaskill.kmer_codes(t(S, d)),
                                      params.to_device(mccaskill._fast_tabs(True), d))

    sc = np.full(2, np.exp(-0.6), np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mccaskill_cuda.mccaskill(prep_on("cpu"), torch.from_numpy(sc))
    pk = mccaskill_cuda.pack(prep_on(dev), torch.from_numpy(sc).to(dev))
    for field, change, match in (
        ("cellf", lambda x: x.double(), "float32"), ("code", lambda x: x.int(), "uint8"),
        ("pout", lambda x: x[:, :-1], "pout"), ("bs_seg", lambda x: x.transpose(1, 2), "contiguous"),
        ("nlen", lambda x: x.cpu(), "nlen"),
    ):
        bad = dict(pk, tensors=dict(pk["tensors"], **{field: change(pk["tensors"][field])}))
        with pytest.raises(ValueError, match=match):
            mccaskill_cuda.launch_args(bad)
    with pytest.raises(ValueError, match="prepare"):
        mccaskill.fold_attempt(tuple(t(a, dev) for a in (S, PT, AP, AU, ns)), pk["tensors"]["sc"],
                               mccaskill.kmer_codes(t(S, dev)), None)


@pytest.mark.parametrize("run", RUNS, ids=[r.id for r in RUNS])
def test_run_on_the_card(run, dev, tmp_path):
    """One end-to-end run of `RUNS` on the card: its output well formed
    (rows, SS_cons), equal to its references, and its kernels launched as
    the row and `card_checks.Launches.hold` say."""
    card_checks.hold_run(run, dev, tmp_path)
