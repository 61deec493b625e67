"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, read by `traffic.py`), its check
(`checks/<workload>.json`: sample sizes and the limits), the check's
reference of the configuration's fold and align models
(`reference/fold/<fold_model>.py`, `reference/align/<align_model>.py`) and
one reader per metric (`metrics/<metric>.py`, a function `read(run)` that
returns a number or None).

A run is a closed loop at concurrency 1.  Set-up imports the port, makes a
CUDA context, builds or loads the kernel library and runs one warm family
of the cell's traffic (its largest size).  The window then runs families
one after another, each through `api.make_dafs(...).run(records)` with its
models built anew as every CLI call builds them, in whole passes of the
mix's pool: it ends at the first end of a pass after `seconds` have
passed, so that every run does the same work.  A traced window ends at
the first family that ends after `seconds` (its metrics have no bound,
and reading the profile of a whole pass would take minutes).
With `trace`, the window runs under a CUDA-only profile and the decode
layer's entries are wrapped (`trace.DecodeTimer`); without it nothing but
the DD entry, the structure decode and the bp-update are wrapped, to keep
the merges' inputs and results, the final decode's input and each
bp-update's input, structure, group and output for the check (references
kept, no copy).

A configuration whose path the check cannot follow stops when its cell is
loaded, before set-up (`unfollowed`): a decoder other than Nussinov, the
host solvers, refinement, four-way PCT, and bp-update under a fold model
whose reference has no constrained re-fold.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = {"jax", "jaxlib", "flax", "dafs_tpu"}
# host phases of `Result.phase_seconds` that run before the merges
PRE_MERGE = ("fold", "align", "save aux", "four-way PCT", "similarity", "PCT")


@dataclasses.dataclass
class Family:
    """What the window kept of one family, for the metric readers."""

    n: int
    residues: int
    pool_index: int
    start: float          # host clock before the models were built
    run_start: float      # before Dafs.run
    end: float
    phase_seconds: dict
    device_dd: list
    consensus_calls: list
    dd_spans: list        # (start, end) of each DD layer call, host clock

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    decodes: list         # (kind, operations, bytes, device seconds)
    device_ops: list
    idle_gaps: list


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    window_s: float
    families: list
    peak_window_bytes: int | None
    trace: Trace | None = None


# -- files found by name -----------------------------------------------------

def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_reader(name: str, root: str = HERE):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def unfollowed(config: dict, root: str = HERE) -> list[str]:
    """The options of `config` whose path the check's reference does not
    follow, each with the reason; empty where it follows them all."""
    from portbench.reference import family

    o = config["options"]
    out = []
    if o.get("fold_decoder", "Nussinov") != "Nussinov":
        out.append(f"fold_decoder {o['fold_decoder']!r} (the reference decodes with Nussinov "
                   "only)")
    if o.get("n_refinement", 0) > 0:
        out.append(f"n_refinement {o['n_refinement']} (the reference does not refine)")
    if o.get("w_pct_f", 0.0) != 0:
        out.append(f"w_pct_f {o['w_pct_f']} (the reference has no four-way PCT)")
    if o.get("dd_host", False):
        out.append("dd_host (the capture wraps the device DD only)")
    if o.get("verbose", 0) >= 2:
        out.append(f"verbose {o['verbose']} (the host DD; the capture wraps the device DD only)")
    if o.get("t_max", 600) == 0:
        out.append("t_max 0 (the ILP; the capture wraps the device DD only)")
    update = [k for k in ("use_bp_update", "use_bp_update1") if o.get(k, False)]
    fold = config["fold_model"]
    if update and not hasattr(family.load_model("fold", fold, root), "constrained_posteriors"):
        out.append(f"{' and '.join(update)} under the fold model {fold!r}, whose reference "
                   f"{family.model_file('fold', fold, root)} has no constrained_posteriors")
    return out


class Cell:
    """A workload of `BENCHMARK.json` with its files."""

    def __init__(self, bench: dict, name: str, root: str = HERE):
        from portbench import traffic
        from portbench.reference import family

        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
        self.spec = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(ROOT, conf["file"]) if not os.path.isabs(conf["file"]) \
            else load_json(conf["file"])
        # the check's reference of each model, before any set-up is paid for
        for kind in ("fold", "align"):
            path = family.model_file(kind, self.config[f"{kind}_model"], root)
            if not os.path.isfile(path):
                raise SystemExit(f"configuration {conf['name']!r} names the {kind} model "
                                 f"{self.config[f'{kind}_model']!r}, which has no reference: "
                                 f"{path} is missing")
        refused = unfollowed(self.config, root)
        if refused:
            raise SystemExit(f"configuration {conf['name']!r}: the check cannot follow "
                             + "; ".join(refused))
        self.mix = traffic.load_mix(self.spec["traffic"], root)
        self.checks = load_json(root, "checks", f"{name}.json")
        self.metrics = {}
        for kind in ("end_to_end", "per_layer"):
            self.metrics[kind] = [
                m for m in bench[kind] if name in m.get("workloads", [name])]
        self.root = root

    def readers(self, kind: str):
        return [(m, load_reader(m["name"], self.root)) for m in self.metrics[kind]]


# -- what the window keeps for the check ------------------------------------

class Capture:
    """Wraps the merges' DD entry (`dafs_tpu_torch.dd.solve_by_dd_batch`),
    the structure decode (`pipeline.Dafs._decode_structure`) and the
    bp-update (`pipeline.Dafs._update_bp`) for the family in flight: each DD
    layer's problems, solutions, (iterations, violations) and host span,
    the last decode's input and structure (the final one's: `SS_cons`), and
    each update's input `p`, structure `ss`, `sstr`, group `aln` (its rows'
    seq ids and masks) and output `out`.  It keeps references and copies
    nothing."""

    def __init__(self):
        from dafs_tpu_torch import dd, pipeline

        self._undo = [(dd, "solve_by_dd_batch", dd.solve_by_dd_batch),
                      (pipeline.Dafs, "_decode_structure", pipeline.Dafs._decode_structure),
                      (pipeline.Dafs, "_update_bp", pipeline.Dafs._update_bp)]
        self.layers: list = []
        self.spans: list = []
        self.final = None
        self.updates: list = []
        solve_orig, decode_orig, update_orig = (orig for _, _, orig in self._undo)

        def solve(problems, **kw):
            stats = kw.get("stats")
            k = len(stats) if stats is not None else 0
            t0 = time.perf_counter()
            sols = solve_orig(problems, **kw)
            self.spans.append((t0, time.perf_counter()))
            self.layers.append((problems, sols, list(stats[k:]) if stats is not None else []))
            return sols

        def decode(dafs, p, th_list):
            ss, sstr = decode_orig(dafs, p, th_list)
            self.final = (p, sstr)
            return ss, sstr

        def update(dafs, p, ss, sstr, aln, use_alifold):
            out = update_orig(dafs, p, ss, sstr, aln, use_alifold)
            self.updates.append(dict(p=p, ss=ss, sstr=sstr, aln=aln, out=out))
            return out

        dd.solve_by_dd_batch = solve
        pipeline.Dafs._decode_structure = decode
        pipeline.Dafs._update_bp = update

    def take(self):
        """(DD layers, DD spans, final decode's (input, structure), updates)
        of the family in flight; starts the next."""
        out = (self.layers, self.spans, self.final, self.updates)
        self.layers, self.spans, self.final, self.updates = [], [], None, []
        return out

    def close(self):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)


class Sample:
    """The families the check compares: the longest the window finished
    and a reservoir of `k - 1` others drawn from the seed."""

    def __init__(self, k: int, rng):
        self.k = k
        self.rng = rng
        self.longest = None
        self.reservoir: list = []

    def offer(self, index: int, size: int, make_cap):
        if self.longest is None or size > self.longest[1]:
            self.longest = (index, size, make_cap())
        if self.k <= 1:
            return
        if len(self.reservoir) < self.k - 1:
            self.reservoir.append((index, make_cap()))
        else:
            j = int(self.rng.integers(index + 1))
            if j < self.k - 1:
                self.reservoir[j] = (index, make_cap())

    def caps(self) -> list:
        if self.longest is None:
            return []
        out = {self.longest[0]: self.longest[2]}
        for i, cap in self.reservoir:
            out.setdefault(i, cap)
        return [out[i] for i in sorted(out)]


# -- the run -----------------------------------------------------------------

def _options(config: dict):
    from dafs_tpu_torch import pipeline

    o = dict(config["options"])
    for k in ("th_s", "th_s1"):
        if o.get(k) is not None:
            o[k] = tuple(o[k])
    return pipeline.Options(**o)


def _family_run(config, records, device):
    from dafs_tpu_torch import api
    from dafs_tpu_torch.fasta import Fasta

    d = api.make_dafs(_options(config), device=device,
                      align_model=config["align_model"], fold_model=config["fold_model"])
    t_run = time.perf_counter()
    d.run([Fasta(n, s) for n, s in records])
    return d, t_run


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _segments(fams: list[Family]):
    """(start, end, label) of what the host did over the window."""
    segs = []
    for f in fams:
        segs.append((f.start, f.run_start, "family set-up"))
        t = f.run_start
        pre = [(k, v) for k, v in f.phase_seconds.items() if k in PRE_MERGE]
        for k, v in pre:
            segs.append((t, t + v, k))
            t += v
        post = sum(v for k, v in f.phase_seconds.items() if k.startswith("final"))
        merge_end = f.end - post
        for s, e in f.dd_spans:
            if s > t:
                segs.append((t, s, "merge consensus and projection"))
            segs.append((s, e, "merge DD"))
            t = e
        if merge_end > t:
            segs.append((t, merge_end, "merge consensus and projection"))
        segs.append((merge_end, f.end, "final consensus and decode"))
    return segs


def idle_by_activity(gaps, segs, top=10):
    """[label, seconds] of the device's idle `gaps` by what the host was
    doing (`segs`, which do not overlap), largest first."""
    segs = sorted(segs)
    tot: dict = {}
    j = 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < ge:
            s, e, label = segs[k]
            part = min(ge, e) - max(gs, s)
            if part > 0:
                tot[label] = tot.get(label, 0.0) + part
                covered += part
            k += 1
        if ge - gs > covered:
            tot["between families"] = tot.get("between families", 0.0) + (ge - gs - covered)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, log=sys.stderr):
    """Returns (result line as a dict, the check's lines)."""
    import torch

    from portbench import check, traffic
    from portbench.reference.family import Reference

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    families = traffic.Families(cell.mix, seed, cell.root)
    config = cell.config

    # set-up: the port's import, the context, the library, one warm family
    _family_run(config, families.warm(), device)
    _sync(device)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else None
    capture = Capture()
    decodes = tracer = None
    if trace and cuda:
        from portbench.trace import DecodeTimer, DeviceTrace

        decodes = DecodeTimer()
        decodes.install()
        tracer = DeviceTrace()
    spec = cell.checks
    sample = Sample(spec["families"], np.random.default_rng([int(seed) % 2**64, 2]))
    fams: list[Family] = []
    attempted = failed = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    if tracer is not None:
        tracer.__enter__()
    setup_s = time.perf_counter() - t_process
    t_win = time.perf_counter()
    try:
        while True:
            records = families.next()
            attempted += 1
            t0 = time.perf_counter()
            try:
                d, t_run = _family_run(config, records, device)
                _sync(device)
            except Exception:  # a family that fails counts; the run goes on
                traceback.print_exc(file=log)
                failed += 1
                capture.take()
                if time.perf_counter() - t_win >= seconds and (trace or families.at_pass_end):
                    break
                continue
            t1 = time.perf_counter()
            layers, spans, final, updates = capture.take()
            res = d.result
            fams.append(Family(
                n=len(records), residues=sum(len(s) for _, s in records),
                pool_index=families.last, start=t0,
                run_start=t_run, end=t1, phase_seconds=dict(res["phase_seconds"]),
                device_dd=list(res["device_dd"]), consensus_calls=list(res["consensus_calls"]),
                dd_spans=spans))
            sample.offer(len(fams) - 1, fams[-1].residues, lambda: dict(
                records=records, bp=d.bp, mp=d.mp, sim=res["similarity"], tree=d.tree,
                rows=res["rows"], ss_cons=res["ss_cons"], layers=layers, final_p=final[0],
                updates=updates))
            del d, res, layers, updates
            if t1 - t_win >= seconds and (trace or families.at_pass_end):
                break
    finally:
        t_end = time.perf_counter()
        if tracer is not None:
            tracer.__exit__(None, None, None)
        capture.close()
    window_s = t_end - t_win
    peak_window = torch.cuda.max_memory_allocated() if cuda else None
    trace_rec = None
    if tracer is not None:
        work = decodes.work()
        decodes.uninstall()
        trace_rec = Trace(
            busy_s=tracer.busy_seconds(t_win, t_end), window_s=window_s, decodes=work,
            device_ops=tracer.device_ops(t_win, t_end),
            idle_gaps=idle_by_activity(tracer.idle_gaps(t_win, t_end), _segments(fams)))
        del tracer, decodes
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    run = Run(setup_s, window_s, fams, peak_window, trace_rec)
    print(f"window: {window_s:.3f} s, {len(fams)} families; wall s by pool index: "
          + " ".join(f"{f.pool_index}:{f.wall:.3f}" for f in fams), file=log)

    # the check, with the program's device state freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(config["options"], config["fold_model"], config["align_model"], device,
                    root=cell.root)
    rng = np.random.default_rng([int(seed) % 2**64, 3])
    numbers: dict = {}
    t_check = time.perf_counter()
    for cap in sample.caps():
        check.plan(cap, spec, rng)
        for k, v in check.check_family(ref, cap).items():
            numbers[k] = max(numbers.get(k, -math.inf), v)
        print(f"check: family of {len(cap['records'])} ({sum(len(s) for _, s in cap['records'])}"
              f" nt): merges compared {cap['compared']['merges']}, bp-updates compared "
              f"{cap['compared']['updates']}, DD merges replayed "
              f"{cap['compared']['replayed']}; seconds {cap['compared'].get('seconds')}; "
              f"{time.perf_counter() - t_check:.1f} s", file=log)
    ok, lines = check.judge(numbers, spec["limits"]) if numbers else (False, ["no family finished"])
    correct = bool(ok and failed == 0 and fams)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m, read in cell.readers(kind):
        v = read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = dict(platform="gpu" if cuda else dev.type,
                       kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                       count=1,
                       memory_peak_bytes=max(peak_setup, peak_window) if cuda else None)
    line = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                device=device_info)
    if trace_rec is not None:
        device_info.update(busy_s=trace_rec.busy_s, window_s=trace_rec.window_s)
        line["breakdown"] = dict(device_ops=trace_rec.device_ops, idle_gaps=trace_rec.idle_gaps)
    # JSON has no infinity: a number that could not be compared reads "inf"
    line["checks"] = {k: {"value": v if v is None or math.isfinite(v) else str(v),
                          "limit": spec["limits"][k]}
                      for k, v in ((k, numbers.get(k)) for k in check.NUMBERS)}
    return line, lines
