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
    alifold, contrafold, cuda_lib, nussinov, nussinov_cuda, nw, nw_cuda, paircrf, pairhmm,
    pairhmm_cuda,
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
    (pairhmm_cuda, "FORWARD"), (pairhmm_cuda, "BACKWARD"), (pairhmm_cuda, "POSTERIOR"),
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
            run = {"FORWARD": pairhmm.forward, "BACKWARD": pairhmm.backward,
                   "POSTERIOR": pairhmm.forward_backward_posterior}[attr]
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


def _quarter_steps(rng, shape):
    """Scores in quarter steps, half the zeros -0.0: frequent exact ties."""
    sm = (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)
    sm[(sm == 0) & (rng.random(shape) < 0.5)] = np.float32(-0.0)
    return sm


def _ragged(rng, B, L, short):
    lens = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    lens[B - short:] = np.arange(short) % 6
    return lens


def _nussinov_stress(dev, rng, B, L, short):
    return (torch.from_numpy(_quarter_steps(rng, (B, L, L))).to(dev),
            torch.from_numpy(_ragged(rng, B, L, short)).to(dev))


def _nw_stress(dev, rng, B, L1, L2, short):
    th = np.float32(0.25)
    sm = np.full((B, L1, L2), -th, np.float32)
    envf = np.zeros((B, L1 + 1), np.int32)
    envl = np.full((B, L1 + 1), L2, np.int32)
    l1 = _ragged(rng, B, L1, short)
    l2 = rng.integers(max(L2 - 40, 0), L2 + 1, size=B).astype(np.int32)
    for b in range(B):
        n1, n2 = int(l1[b]), int(l2[b])
        p = np.abs(_quarter_steps(rng, (n1, n2))) * (rng.random((n1, n2)) < 0.3)
        s = np.float32(p - th + np.abs(_quarter_steps(rng, (n1, n2))) / 2)
        s[rng.random((n1, n2)) < 0.05] = np.float32(-0.0)
        env = nw.envelope(p, th)
        sm[b, :n1, :n2] = s
        envf[b, : n1 + 1] = env[:, 0]
        envl[b, : n1 + 1] = env[:, 1]
    return [torch.from_numpy(a).to(dev) for a in (sm, envf, envl, l1, l2)]


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
    def seqs(lens):
        return ["".join(rng.choice(list("ACGU"), size=int(n))) for n in lens]
    c1, n1 = pairhmm.encode_batch(seqs(lens1), l1max)
    c2, n2 = pairhmm.encode_batch(seqs(lens2), l2max)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


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
    the tree line, SS_cons and every row equal the frozen output (as
    chip_smoke.py's solvers phase checks)."""
    import chip_smoke

    chip_smoke.replay_rf00017(dev)


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
    """All-pairs, fold and both PCTs on a two-shard mesh of this card (and
    across the cards where there are several) equal the single-device run
    bit for bit."""
    from dafs_tpu_torch import consistency
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.parallel import mesh

    fa = load_fasta("tests/data/RF00005_0.fa")
    lens = [len(f.seq) for f in fa]

    def stages():
        bp = fold_models.RNAfold(True, 1e-4).all_seqs(fa, dev)
        mp = align_models.ProbCons(0.01).all_pairs(fa, dev)
        sim = consistency.similarity_matrix(mp, lens, dev)
        return (bp, mp, consistency.relax_basepairing_probability(bp, mp, sim, lens, 0.25, dev),
                consistency.relax_matching_probability(mp, sim, lens, 0.25, dev))

    with mesh.force_single_device():
        want = stages()
    for shards in ({2} | {torch.cuda.device_count()}) - {1}:
        with mesh.virtual_mesh(shards):
            got = stages()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


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
