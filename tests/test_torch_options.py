"""The options of the last single-card slice against `dafs_tpu` on the CPU:
four-way PCT, the adagrad and adam DD updates, refinement's random stream and
bipartitions, the aux files and the parameter-file loader.

Four-way PCT is numpy matrix products in `dafs_tpu`; on the CPU
`torch.matmul` reduces in the same order, so the port is held bit-equal.

adagrad and adam are held at a stated tolerance on s, with (x, y, z) equal,
on problems that converge before the iteration cap.  Two ops of XLA's CPU
code differ from IEEE float32 in the last bit:
  - adagrad: XLA rewrites `a / sqrt(b)` into `a * rsqrt(b)`, and its CPU
    rsqrt is an approximation within one ulp of the rounded value (measured:
    14 % of 2e5 inputs off by one ulp); the port divides by a rounded sqrt;
  - adam: XLA's `power` for `b ** (t + 1)` is its own expansion, not the C
    library's powf; 2 of the 600 values of 1 - 0.9 ** (t + 1) and 120 of
    1 - 0.999 ** (t + 1) differ by one ulp from numpy's float32 power, which
    the port takes (`dd._adam_bias_corrections`).
The multipliers therefore differ in the last bits, and s (a sum of
multipliers and decoder scores) by a few ulps: |s - s_jax| <= S_RTOL |s_jax|.
The DD references run in a subprocess with XLA's CPU code generation capped
below FMA (`--xla_cpu_max_isa=AVX`), as the whole-slice tests do.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dafs_tpu import consistency as j_cons
from dafs_tpu import pipeline as j_pipeline
from dafs_tpu.ops import energy_params as j_ep
from dafs_tpu.ops import param_file as j_pf
from dafs_tpu.typedefs import AlnRow as JAlnRow
from dafs_tpu_torch import cli, pipeline
from dafs_tpu_torch import consistency as t_cons
from dafs_tpu_torch import dd as t_dd
from dafs_tpu_torch.ops import alifold, mccaskill
from dafs_tpu_torch.ops import energy_params as t_ep
from dafs_tpu_torch.ops import param_file as t_pf
from dafs_tpu_torch.typedefs import CUTOFF, AlnRow
from dafs_tpu_torch.utils.crand import GlibcRand
from tests.test_torch_dd import KW, _problems
from tests.test_torch_pipeline import FAMILIES

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_RTOL = 4 * 2.0 ** -23  # four float32 ulps of s
DD_SEEDS = [1, 16, 19]

_JAX_REFERENCE = """
import contextlib, io, json, sys
from dafs_tpu import cli, dd
from dafs_tpu.ops import alifold
from dafs_tpu.parallel.mesh import force_single_device
from tests.test_torch_dd import KW, _problems
args = json.loads(sys.stdin.read())
out = {"dd": {}, "cli": {}}
for rule in ("adagrad", "adam"):
    for seed in args["dd_seeds"]:
        sols = dd.solve_by_dd_batch(_problems(seed), update_rule=rule, **KW)
        out["dd"][f"{rule} {seed}"] = [[s, x.tolist(), y.tolist(), z.tolist()]
                                       for s, x, y, z in sols]
for name, flags in args["cli"].items():
    alifold._SC_CACHE.clear()
    buf = io.StringIO()
    with force_single_device(), contextlib.redirect_stdout(buf):
        cli.main(flags)
    out["cli"][name] = buf.getvalue()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    path = tmp_path_factory.mktemp("fa") / "seeded.fa"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in FAMILIES["seeded_5x52"]))
    return str(path)


def _save(d):
    return ["--save-align-aux", str(d / "mp.txt"), "--save-fold-aux", str(d / "bp.txt")]


def _load(d):
    return ["--align-aux", str(d / "mp.txt"), "--fold-aux", str(d / "bp.txt")]


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory, family):
    """`dafs_tpu`'s DD under both rules on test_torch_dd's problems, and its
    CLI on the seeded family: a run that dumps the aux files into `save/`,
    and a run that reads them back and dumps them again into `again/`."""
    d = tmp_path_factory.mktemp("jax_aux")
    runs = {"save": [*_save(d / "save"), family],
            "load": [*_load(d / "save"), *_save(d / "again"), family]}
    for sub in ("save", "again"):
        (d / sub).mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_REFERENCE],
        input=json.dumps(dict(dd_seeds=DD_SEEDS, cli=runs)),
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=900, check=True,
    )
    return json.loads(proc.stdout.strip().splitlines()[-1]), d


# -- four-way PCT -------------------------------------------------------------


def _posteriors(rng, lens):
    """Sparse match and pair posteriors in the pipeline's layout: mp[x, y]
    for x < y, its transpose, the identity on the diagonal, bp upper
    triangular; zeros past each length."""
    N, L = len(lens), max(lens)
    mp = np.zeros((N, N, L, L), np.float32)
    bp = np.zeros((N, L, L), np.float32)
    for x in range(N):
        lx = lens[x]
        b = np.where(rng.random((lx, lx)) < 0.08, rng.random((lx, lx)), 0.0)
        bp[x, :lx, :lx] = np.triu(b, 1)
        mp[x, x][np.arange(lx), np.arange(lx)] = 1.0
        for y in range(x + 1, N):
            ly = lens[y]
            band = np.abs(np.arange(lx)[:, None] * ly / lx - np.arange(ly)[None, :]) < 4
            m = np.where(band & (rng.random((lx, ly)) < 0.7), rng.random((lx, ly)), 0.0)
            mp[x, y, :lx, :ly] = m
            mp[y, x, :ly, :lx] = m.T
    return mp, bp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fourway_matches_jax(seed):
    """The port's four-way PCT on the CPU equals `dafs_tpu`'s bit for bit."""
    rng = np.random.default_rng(seed)
    lens = [int(v) for v in rng.integers(40, 76, size=4)]
    mp, bp = _posteriors(rng, lens)
    got = t_cons.relax_fourway_consistency(mp, bp, lens, 0.5, "cpu")
    want = j_cons.relax_fourway_consistency(mp, bp, lens, 0.5)
    np.testing.assert_array_equal(got, want)
    # the transformation did something: entries moved, some crossed CUTOFF
    assert not np.array_equal(got, mp)
    assert ((mp > CUTOFF) != (got > CUTOFF)).any()


# -- the adagrad and adam DD updates ------------------------------------------


@pytest.mark.parametrize("seed", DD_SEEDS)
@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_update_rules_match_jax(rule, seed, jax_reference):
    """(x, y, z) equal to `dafs_tpu`'s batched DD; s to S_RTOL (see the
    module docstring for the two XLA ops behind it)."""
    stats = []
    got = t_dd.solve_by_dd_batch(_problems(seed), device="cpu", update_rule=rule,
                                 stats=stats, **KW)
    assert all(v == 0 and t < KW["t_max"] for t, v in stats)
    for (s_g, *xyz_g), (s_w, *xyz_w) in zip(got, jax_reference[0]["dd"][f"{rule} {seed}"],
                                            strict=True):
        for u, v in zip(xyz_g, xyz_w):
            np.testing.assert_array_equal(u, np.asarray(v))
        assert abs(s_g - s_w) <= S_RTOL * abs(s_w)


def test_update_rules_differ_from_subgradient():
    """The rules are not the subgradient step under another name: on the
    same problems each takes its own number of iterations."""
    steps = {}
    for rule in ("subgradient", "adagrad", "adam"):
        stats = []
        t_dd.solve_by_dd_batch(_problems(1), device="cpu", update_rule=rule, stats=stats, **KW)
        steps[rule] = [t for t, _ in stats]
    assert len({tuple(v) for v in steps.values()}) == 3


def test_adam_bias_corrections():
    bc1, bc2 = t_dd._adam_bias_corrections(600)
    assert bc1.dtype == bc2.dtype == np.float32 and bc1.shape == (600,)
    assert bc1[0] == np.float32(1.0) - np.float32(0.9)
    assert bc2[-1] == np.float32(1.0) - np.power(np.float32(0.999), np.float32(600))


# -- refinement ---------------------------------------------------------------


def test_glibc_rand_known_stream():
    """glibc rand() with no srand = seed 1; first values are well known."""
    r = GlibcRand()
    got = [r.rand() for _ in range(10)]
    assert got == [
        1804289383, 846930886, 1681692777, 1714636915, 1957747793,
        424238335, 719885386, 1649760492, 596516649, 1189641421,
    ]


class _FakeSeq:
    def __init__(self, name, seq):
        self.name, self.seq = name, seq

    def __len__(self):
        return len(self.seq)


def _captured_refinements(d, rows, n, phases_arg):
    captured = []

    def fake_merge(a1, a2, *phases):
        assert len(phases) == phases_arg
        captured.append(([r.seq_id for r in a1], [r.seq_id for r in a2],
                         [r.mask.copy() for r in a1 + a2]))
        return 1.0, None, a1 + a2

    d.fa = [_FakeSeq(c, "GGAACC") for c in "abcdefghij"[: len(rows)]]
    d._align_alignments = fake_merge
    for _ in range(n):
        if phases_arg:
            d._refine(rows, {})
        else:
            d._refine(None, rows)
    return captured


def test_refine_bipartition_sequence():
    """DAFS::refine consumes rand() % 2 per sequence (src/dafs.cpp:1546-1551);
    fixed stream -> fixed bipartitions, and all-gap columns are stripped."""
    d = pipeline.Dafs(None, None, pipeline.Options(), device="cpu")
    masks = np.ones((4, 8), bool)
    masks[1, 7] = False  # column 7 is a gap of sequence 1 alone
    aln = [AlnRow(i, masks[i]) for i in range(4)]
    captured = _captured_refinements(d, aln, 2, 1)
    # glibc stream % 2: 1,0,1,1 -> groups [1], [0,2,3]; then 1,1,0,0 ->
    # groups [2,3], [0,1]
    assert captured[0][0] == [1] and captured[0][1] == [0, 2, 3]
    assert captured[1][0] == [2, 3] and captured[1][1] == [0, 1]
    # group [1] drops its all-gap column 7 -> mask length 7
    assert len(captured[0][2][0]) == 7


def test_refine_sequence_matches_jax():
    """Ten refinements of a ten-row alignment: the same groups and masks as
    `dafs_tpu`'s `_refine`, each `Dafs` with its own stream."""
    rng = np.random.default_rng(3)
    masks = rng.random((10, 30)) < 0.8
    got = _captured_refinements(pipeline.Dafs(None, None, pipeline.Options(), device="cpu"),
                                [AlnRow(i, masks[i]) for i in range(10)], 10, 1)
    want = _captured_refinements(j_pipeline.Dafs(None, None, j_pipeline.Options()),
                                 [JAlnRow(i, masks[i]) for i in range(10)], 10, 0)
    for (a1, a2, m), (b1, b2, n) in zip(got, want, strict=True):
        assert a1 == b1 and a2 == b2
        assert all(np.array_equal(u, v) for u, v in zip(m, n, strict=True))


# -- the aux files ------------------------------------------------------------


def _aux_entries(path):
    """{(x, i, j): p} of a fold aux file."""
    out, x = {}, None
    for line in open(path):
        parts = line.split()
        if parts[0] == ">":
            x = int(parts[1])
            continue
        for tok in parts[1:]:
            j, p = tok.split(":")
            out[(x, int(parts[0]), int(j))] = float(p)
    return out


def test_aux_round_trip_matches_jax(jax_reference, family, tmp_path, capsys):
    """The aux dumps of the seeded family against `dafs_tpu`'s.

    The match posteriors are bit-equal across the packages, so the align
    dump is byte-equal.  The port's McCaskill is held to `dafs_tpu`'s at
    tests/test_torch_mccaskill.py's tolerance (atol 3e-5, rtol 3e-3), not
    bit for bit, so the fold dump has the same entries at that tolerance.
    Read back and dumped again, both packages' files are byte-equal: reader
    and writer agree on the same data.  The reloads print the JAX CLI's
    output, and the port's reload of its own files its first run's."""
    want, jdir = jax_reference
    for sub in ("save", "again", "own"):
        (tmp_path / sub).mkdir()
    assert cli.main([*_save(tmp_path / "save"), "--device", "cpu", family]) == 0
    first = capsys.readouterr().out
    assert first == want["cli"]["save"]
    assert (tmp_path / "save" / "mp.txt").read_bytes() == (jdir / "save" / "mp.txt").read_bytes()
    got, ref = (_aux_entries(d / "save" / "bp.txt") for d in (tmp_path, jdir))
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose([got[k] for k in ref], list(ref.values()), atol=3e-5, rtol=3e-3)

    assert cli.main([*_load(jdir / "save"), *_save(tmp_path / "again"), "--device", "cpu",
                     family]) == 0
    assert capsys.readouterr().out == want["cli"]["load"]
    for name in ("mp.txt", "bp.txt"):
        again = (tmp_path / "again" / name).read_bytes()
        assert again == (jdir / "again" / name).read_bytes() == (jdir / "save" / name).read_bytes()
        assert again.startswith(b"> 1")
    assert cli.main([*_load(tmp_path / "save"), "--device", "cpu", family]) == 0
    assert capsys.readouterr().out == first


def test_aux_models_read_back_exactly(tmp_path):
    """A dump read back by AUXAlign and AUXFold gives the arrays that were
    dumped, bit for bit (`%.9g` prints a float32 exactly)."""
    from dafs_tpu_torch.fasta import Fasta
    from dafs_tpu_torch.models import align_models, fold_models

    rng = np.random.default_rng(5)
    lens = [23, 31, 27]
    mp, bp = _posteriors(rng, lens)
    fa = [Fasta(f"s{i}", "A" * n) for i, n in enumerate(lens)]
    d = pipeline.Dafs(None, None, pipeline.Options(save_align_aux=str(tmp_path / "mp"),
                                                   save_fold_aux=str(tmp_path / "bp")),
                      device="cpu")
    d.mp, d.bp = mp, bp
    d._save_aux(lens)
    np.testing.assert_array_equal(
        align_models.AUXAlign(str(tmp_path / "mp"), 0.01).all_pairs(fa, "cpu"), mp)
    np.testing.assert_array_equal(
        fold_models.AUXFold(str(tmp_path / "bp"), CUTOFF).all_seqs(fa, "cpu"), bp)
    with pytest.raises(NotImplementedError):
        fold_models.AUXFold(str(tmp_path / "bp"), CUTOFF).batch_bp_posteriors(
            ["AAAA"], "cpu", constraints=["(..)"])


# -- parameter files ----------------------------------------------------------


def _write(tmp_path, body: str) -> str:
    p = tmp_path / "test.par"
    p.write_text("## RNAfold parameter file v2.0\n" + textwrap.dedent(body))
    return str(p)


_STACK = "\n".join(" ".join(str(v) for v in r) for r in np.arange(49).reshape(7, 7) * 10 - 240)
_MM = " ".join(str(v) for v in np.where(np.arange(175) == 6, -150, 0))
PAR_BODIES = {
    "stack_and_scalars": f"""
    # stack
    /*  CG    GC    GU    UG    AU    UA    NN  */
    {_STACK}
    # ML_params
    0 0 340 0 40 0
    # NINIO
    60 320 300
    # Misc
    410 360 50 370
    """,
    "inf_and_loop_lengths": f"""
    # hairpin
    {' '.join(['INF'] * 3 + [str(540 + i) for i in range(28)])}
    """,
    "special_loops_and_mismatch": f"""
    # mismatch_hairpin
    {_MM}
    # Tetraloops
    CGAAAG -160 200
    CUUCGG -190 220
    """,
    "test_file": open(os.path.join(ROOT, "tests", "data", "ml_ninio.par")).read().split("\n", 1)[1],
}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("name", sorted(PAR_BODIES))
def test_param_file_parses_as_jax(name, tmp_path):
    path = _write(tmp_path, PAR_BODIES[name])
    got = t_pf.load_param_file(path)
    assert got
    _same(got, j_pf.load_param_file(path))


@pytest.mark.parametrize("body,match", [
    (None, "v2.0"),
    ("# stack\n1 2 3\n", "stack"),
    ("# ML_params\n1 2 3\n", "ML_params"),
    ("# Tetraloops\nCGAAG -160 200\n", "Tetraloops"),
])
def test_param_file_rejects_as_jax(body, match, tmp_path):
    if body is None:
        path = tmp_path / "bad.par"
        path.write_text("# stack\n1 2 3\n")
        path = str(path)
    else:
        path = _write(tmp_path, body)
    for loader in (t_pf.load_param_file, j_pf.load_param_file):
        with pytest.raises(ValueError, match=match):
            loader(path)


def test_overrides_change_fold_and_reset(tmp_path):
    """A parameter file changes McCaskill's posteriors and clears every table
    memo; resetting the overrides gives the first posteriors back bit for
    bit."""
    seq = "GGGCAACGACGUUCGUCGAAACCC"
    base = mccaskill.batch_bp_posteriors_fast([seq], 0.01, "cpu")[0]
    alifold._tables(True, 2)
    # forbid every generic hairpin: the pairing ensemble collapses
    path = _write(tmp_path, f"""
    # hairpin
    {' '.join(['INF'] * 31)}
    """)
    try:
        over = t_pf.apply_param_file(path)
        assert t_ep.PARAM_OVERRIDES == over and t_ep.params()["hairpin"][5] == t_ep.INF
        assert not mccaskill._FAST_TABLES and not alifold._TABLES
        new = mccaskill.batch_bp_posteriors_fast([seq], 0.01, "cpu")[0]
    finally:
        t_ep.set_param_overrides({})
    assert float(base.sum()) > 2.0
    assert float(new.sum()) < 0.5 * float(base.sum())
    assert t_ep.PARAM_OVERRIDES == {} and j_ep.PARAM_OVERRIDES == {}
    np.testing.assert_array_equal(mccaskill.batch_bp_posteriors_fast([seq], 0.01, "cpu")[0], base)


def test_api_param_file_equals_cli(tmp_path, capsys):
    """`param_file=` of the API equals `-P` of the CLI, and the override
    changes the output of the seeded family's fold."""
    import dafs_tpu_torch
    from dafs_tpu_torch.fasta import Fasta

    par = os.path.join(ROOT, "tests", "data", "ml_ninio.par")
    recs = [Fasta(n, s) for n, s in FAMILIES["seeded_5x52"][:3]]
    fa = tmp_path / "f.fa"
    fa.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    plain = mccaskill.batch_bp_posteriors_fast([recs[0].seq], 0.01, "cpu")[0]
    try:
        res = dafs_tpu_torch.align_and_fold(recs, device="cpu", param_file=par)
        changed = mccaskill.batch_bp_posteriors_fast([recs[0].seq], 0.01, "cpu")[0]
        t_ep.set_param_overrides({})
        assert cli.main(["-P", par, "--device", "cpu", str(fa)]) == 0
    finally:
        t_ep.set_param_overrides({})
    assert capsys.readouterr().out == str(res)
    assert not np.array_equal(plain, changed)
