"""The port's host merge solvers against `dafs_tpu` on the CPU.

`dd.solve_by_dd_ipknot` (the host-loop DD, under both structure decoders)
and `dd.solve_by_ip` (the exact joint ILP of `-m 0`) are held to their
`dafs_tpu.dd` counterparts on seeded random problems: (s, x, y, z) and the
per-iteration `trace_cb` stream must be equal.  The JAX package's loop
decodes with its native C++ decoders, the port's with its own (the plain
versions on the CPU), which must agree bit for bit with them, so the
multipliers of the two loops stay equal.  Both are host numpy arithmetic,
so these run in this process.

Then the pipeline: `--ipknot`, `-v 2`, `-m 0` and `dd_host=True` on the two
small families of tests/test_torch_pipeline.py against `dafs_tpu`'s runs of
the same options, in one subprocess with XLA's CPU code generation capped
below FMA (`--xla_cpu_max_isa=AVX`), as the other parity tests do.  The
standard output must be the JAX CLI's bytes (the `-v 2` dumps included),
and every consensus call's route and ladder attempts equal.  RF00005
under `--ipknot` and `-m 0` must print `tests/snapshots/rf00005_ipknot_cpu.txt`
and `rf00005_ilp_cpu.txt`, recorded with
`JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_max_isa=AVX python -m dafs_tpu.cli
--ipknot|-m 0 tests/data/RF00005_0.fa`.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dafs_tpu import dd as j_dd
from dafs_tpu_torch import cli, dd, guide_tree, pipeline
from dafs_tpu_torch.fasta import Fasta, load_fasta
from dafs_tpu_torch.models import align_models, fold_models
from dafs_tpu_torch.ops import alifold
from dafs_tpu_torch.typedefs import CUTOFF, AlnRow
from tests.merge_problems import KW, PROBLEMS, _problem
from tests.test_solve_ip import _consistent_problem
from tests.test_torch_pipeline import FAMILIES, TINY

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP = os.path.join(ROOT, "tests", "snapshots")


def _both_loops(problem, decoder, t_max=80):
    p_x, p_y, p_z = _problem(*problem[:3])
    n1, n2 = problem[3:]
    kw = dict(KW, t_max=t_max, structure_decoder=decoder)
    got_tr, want_tr = [], []
    got = dd.solve_by_dd_ipknot(p_x, p_y, p_z, n1, n2, device="cpu",
                                trace_cb=lambda *a: got_tr.append(a), **kw)
    want = j_dd.solve_by_dd_ipknot(p_x, p_y, p_z, n1, n2,
                                   trace_cb=lambda *a: want_tr.append(a), **kw)
    return got, want, got_tr, want_tr


def _assert_same_solution(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("decoder", ["nussinov", "ipknot"])
@pytest.mark.parametrize("problem", PROBLEMS, ids=[f"{p[1]}x{p[2]}" for p in PROBLEMS])
def test_dd_ipknot_matches_jax(problem, decoder):
    got, want, got_tr, want_tr = _both_loops(problem, decoder)
    _assert_same_solution(got, want)
    assert got_tr == want_tr and got_tr


def test_dd_ipknot_verbose_callback_matches_jax():
    """verbose_cb sees (x, y, z) of every iteration, as in the JAX package."""
    p_x, p_y, p_z = _problem(7, 30, 34)
    seen = ([], [])
    for solve, out, extra in ((dd.solve_by_dd_ipknot, seen[0], dict(device="cpu")),
                              (j_dd.solve_by_dd_ipknot, seen[1], {})):
        solve(p_x, p_y, p_z, 2, 1, t_max=30, structure_decoder="nussinov",
              verbose_cb=lambda x, y, z, out=out: out.append((x.tolist(), y.tolist(), z.tolist())),
              **KW, **extra)
    assert seen[0] == seen[1] and seen[0]


def test_dd_ipknot_length_zero():
    """A side of length 0 (the JAX package's native decoder reads out of
    bounds there, so the port is checked alone): x and z are empty, y is
    the other side's own structure, which the loop drives to no pairs."""
    _, p_y, _ = _problem(8, 5, 24)
    p_x = np.zeros((0, 0), np.float32)
    p_z = np.zeros((0, 24), np.float32)
    s, x, y, z = dd.solve_by_dd_ipknot(p_x, p_y, p_z, 1, 1, device="cpu", t_max=50,
                                       structure_decoder="nussinov", **KW)
    assert x.shape == (0,) and z.shape == (0,) and y.shape == (24,)
    assert np.isfinite(s)


def test_dd_ipknot_no_highs_binding_falls_back(monkeypatch):
    """Without a HiGHS binding the IPknot loop warns and decodes with
    per-iteration `milp` calls, as the JAX package does."""
    from dafs_tpu.decoders_ip import ipknot as j_ipknot
    from dafs_tpu_torch.decoders_ip import ipknot

    def missing():
        raise ImportError("no HiGHS binding")

    monkeypatch.setattr(ipknot, "_highs_core", missing)
    monkeypatch.setattr(j_ipknot, "_highs_core", missing)
    records = []
    handler = type("H", (__import__("logging").Handler,), {"emit": lambda self, r: records.append(r)})()
    dd.logger.addHandler(handler)
    try:
        got, want, got_tr, want_tr = _both_loops(PROBLEMS[2], "ipknot", t_max=20)
    finally:
        dd.logger.removeHandler(handler)
    _assert_same_solution(got, want)
    assert got_tr == want_tr
    assert any("falling back" in r.getMessage() for r in records)


IP_CASES = {
    "consistent": (_consistent_problem(), 1, 1),
    "empty": ((np.zeros((8, 8), np.float32),) * 3, 1, 1),
    "random_20x24": (_problem(10, 20, 24), 2, 1),
    "random_30x28": (_problem(11, 30, 28), 1, 2),
}


@pytest.mark.parametrize("case", sorted(IP_CASES))
def test_solve_by_ip_matches_jax(case):
    (p_x, p_y, p_z), n1, n2 = IP_CASES[case]
    got = dd.solve_by_ip(p_x, p_y, p_z, n1, n2, t_max=0, **KW)
    want = j_dd.solve_by_ip(p_x, p_y, p_z, n1, n2, t_max=0, **KW)
    _assert_same_solution(got, want)


def test_solve_by_ip_fix_z_matches_jax():
    (p_x, p_y, p_z), n1, n2 = IP_CASES["random_20x24"]
    fix = {(i, min(i + 1, 23)) for i in range(0, 20, 2)}
    _assert_same_solution(dd.solve_by_ip(p_x, p_y, p_z, n1, n2, fix_z=fix, **KW),
                          j_dd.solve_by_ip(p_x, p_y, p_z, n1, n2, fix_z=fix, **KW))


# ------------------------------------------------------------ the pipeline --

MODES = {"ipknot": ["--ipknot"], "v2": ["-v", "2"], "m0": ["-m", "0"], "dd_host": None}

_JAX_REFERENCE = """
import contextlib, io, json, sys
from dafs_tpu import cli, pipeline
from dafs_tpu.fasta import Fasta
from dafs_tpu.models import align_models, fold_models
from dafs_tpu.ops import alifold
from dafs_tpu.ops import alifold_kernel
from dafs_tpu.parallel.mesh import force_single_device

# record every consensus call as the port does: (n_seq, n, route, attempts)
calls = []
_consensus, _fast = alifold.consensus_bp, alifold_kernel.alifold_fast
def consensus_bp(seqs, *a, **k):
    single = len(seqs) == 1 and "-" not in seqs[0] and "_" not in seqs[0]
    calls.append([len(seqs), len(seqs[0]), "mccaskill" if single else "alifold",
                  None if single else 0])
    return _consensus(seqs, *a, **k)
def alifold_fast(*a, **k):
    calls[-1][3] += 1
    return _fast(*a, **k)
alifold.consensus_bp, alifold_kernel.alifold_fast = consensus_bp, alifold_fast

args = json.loads(sys.stdin.read())
out = {}
for key, flags, path, recs in args["runs"]:
    alifold._SC_CACHE.clear()
    calls.clear()
    buf = io.StringIO()
    with force_single_device(), contextlib.redirect_stdout(buf):
        if flags is None:
            d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, 0.01),
                              pipeline.Options(dd_host=True),
                              alifold_model=alifold.Alifold(0.0, bl=True))
            sys.stdout.write(d.run([Fasta(n, s) for n, s in recs]))
        else:
            cli.main([*flags, path])
    out[key] = dict(stdout=buf.getvalue(), calls=[list(c) for c in calls])
print(json.dumps(out))
"""


def _port_run(flags, recs):
    """The port's run of one mode: (standard output, consensus calls, host
    DD merges).  The CLI's options and models, with the `Alifold` kept for
    its records."""
    opts = (pipeline.Options(dd_host=True) if flags is None
            else cli.options_from_args(cli.build_parser().parse_args([*flags, "x.fa"])))
    d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, CUTOFF), opts,
                      alifold_model=alifold.Alifold(0.0, bl=True), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sys.stdout.write(d.run([Fasta(n, s) for n, s in recs]))
    return buf.getvalue(), d.result["consensus_calls"], d.result["host_dd"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{mode/family: (port stdout, port calls, JAX result)}, and the JAX CLI's
    output of each mode on the tiny family from its file.  The port's runs
    are made while the JAX reference runs in its subprocess."""
    tmp = tmp_path_factory.mktemp("jax")
    tiny = tmp / "tiny.fa"
    tiny.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    runs = []
    for fam, recs in sorted(FAMILIES.items()):
        path = tmp / f"{fam}.fa"
        path.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
        runs += [(f"{m}/{fam}", flags, str(path), recs) for m, flags in MODES.items()]
    (tmp / "args.json").write_text(json.dumps(dict(runs=runs)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    with open(tmp / "args.json") as fin, open(tmp / "out", "w") as fout, \
            open(tmp / "err", "w") as ferr:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_REFERENCE], stdin=fin,
                                stdout=fout, stderr=ferr, cwd=ROOT, env=env)
        try:
            got = {key: _port_run(flags, recs) for key, flags, _, recs in runs}
            proc.wait(timeout=1200)
        finally:
            proc.kill()
    assert proc.returncode == 0, (tmp / "err").read_text()[-3000:]
    want = json.loads((tmp / "out").read_text().strip().splitlines()[-1])
    return {k: (*got[k], want[k]) for k in got}, tmp


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mode_matches_jax(mode, family, results):
    """The standard output equals `dafs_tpu`'s bytes (the JAX CLI's for the
    CLI modes), and every consensus call has the same route and attempts."""
    out, calls, _, want = results[0][f"{mode}/{family}"]
    assert out == want["stdout"]
    routes = [[c["ns"], c["n"], "mccaskill" if c["route"] == "fold stage" else c["route"],
               c["attempts"]] for c in calls]
    assert routes == want["calls"]
    n = len(FAMILIES[family])
    if mode == "v2":
        # one dump of two blocks per DD iteration, then the result
        assert out.count("\n\n") >= n - 1
    if mode == "ipknot":
        # the final decode runs bp-update at two bracket levels
        assert len(routes) == (n - 1) * 2 + 1 + 2


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_result_records_host_dd_merges(mode, family, results):
    """`host_dd` holds (iterations, violations at exit) for each merge the
    host DD loop solved: none under the exact ILP; under `-v 2` as many
    iterations as dumps; a merge ends converged or at the cap."""
    out, _, host_dd, _ = results[0][f"{mode}/{family}"]
    if mode == "m0":
        assert host_dd == []
        return
    assert len(host_dd) == len(FAMILIES[family]) - 1
    for t, violated in host_dd:
        assert 1 <= t <= 600 and violated >= 0 and (violated == 0 or t == 600)
    if mode == "v2":
        assert out.count("\n\n") == sum(t for t, _ in host_dd)


@pytest.mark.parametrize("mode", ["ipknot", "m0", "v2"])
def test_cli_prints_jax_bytes(mode, results, capsys):
    """The port's CLI itself, on the seeded family: the same bytes (under
    `-v 2` the dumps and the result, as one standard output)."""
    res, tmp = results
    family = "seeded_5x52"
    assert cli.main([*MODES[mode], "--device", "cpu", str(tmp / f"{family}.fa")]) == 0
    assert capsys.readouterr().out == res[f"{mode}/{family}"][-1]["stdout"]


@pytest.mark.parametrize("mode,snapshot", [
    pytest.param("ipknot", "rf00005_ipknot_cpu.txt", marks=pytest.mark.slow),
    ("m0", "rf00005_ilp_cpu.txt"),
])
def test_rf00005_matches_snapshot(mode, snapshot, capsys):
    """RF00005 under `--ipknot` (about 90 s on one CPU thread, marker slow)
    and `-m 0` (about 40 s): `dafs_tpu`'s CPU output, byte for byte."""
    assert cli.main([*MODES[mode], "--device", "cpu",
                     os.path.join(ROOT, "tests", "data", "RF00005_0.fa")]) == 0
    with open(os.path.join(SNAP, snapshot)) as fh:
        assert capsys.readouterr().out == fh.read()


def test_profile_writes_a_trace(tmp_path, capsys):
    """`--profile DIR` runs under torch.profiler and writes a Chrome trace."""
    fa = tmp_path / "tiny.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    out_dir = tmp_path / "prof" / "run"
    assert cli.main(["--device", "cpu", "--profile", str(out_dir), str(fa)]) == 0
    plain = capsys.readouterr().out
    trace = json.loads((out_dir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert cli.main(["--device", "cpu", str(fa)]) == 0
    assert capsys.readouterr().out == plain


# ------------------------------------------------------ the RF00017 replay --


def _replay_first_merge():
    """The inputs of the first merge of the RF00017 frozen replay
    (tests/test_rf00017_replay.py): the recorded posteriors and the first
    two recorded consensus matrices, averaged by the port."""
    data = np.load(os.path.join(SNAP, "rf00017_replay.npz"))
    fa = load_fasta(os.path.join(ROOT, "tests", "data", "RF00017_4.fa"))
    assert [f.name for f in fa] == list(data["names"])
    tree = guide_tree.build_tree(data["sim"])

    def first(n):
        l, r = tree[n][1]
        for c in (l, r):
            if tree[c][1][0] != -1:
                return first(c)
        return n

    calls = iter(range(int(data["n_ali_calls"])))

    class ReplayAlifold:
        def consensus_bp(self, aln, fa_, device, constraint=None):
            return data[f"ali_out_{next(calls)}"]

    d = pipeline.Dafs(None, None, pipeline.Options(dd_host=True),
                      alifold_model=ReplayAlifold(), device="cpu")
    d.fa, d.mp, d.bp, d.tree = fa, data["mp"], data["bp"], tree
    l, r = tree[first(len(tree) - 1)][1]
    return d._merge_inputs(*([AlnRow(k, np.ones(len(fa[k]), dtype=bool))] for k in (l, r)))


@pytest.mark.parametrize("decoder,t_max", [
    ("nussinov", 40),
    pytest.param("nussinov", 600, marks=pytest.mark.slow),
    ("ipknot", 3),
])
def test_replay_first_merge_matches_jax(decoder, t_max):
    """The replay's first merge (298 x 295 columns) through both host
    loops: (s, x, y, z) and the trace equal.  All 600 iterations (it stops
    at the cap) take about 200 s on one CPU thread with the plain decoders:
    marker slow."""
    p_x, p_y, p_z = _replay_first_merge()
    kw = dict(KW, t_max=t_max, structure_decoder=decoder)
    got_tr, want_tr = [], []
    got = dd.solve_by_dd_ipknot(p_x, p_y, p_z, 1, 1, device="cpu",
                                trace_cb=lambda *a: got_tr.append(a), **kw)
    want = j_dd.solve_by_dd_ipknot(p_x, p_y, p_z, 1, 1,
                                   trace_cb=lambda *a: want_tr.append(a), **kw)
    _assert_same_solution(got, want)
    assert got_tr == want_tr and len(got_tr) == t_max
