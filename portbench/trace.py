"""Device activity of the traced window, from `torch.profiler` (CUDA
activity only: host-side tracing of millions of eager ops would cost more
than the run), and the decodes' own device time from CUDA events.

`busy_seconds` is `tools/torch_profile.py`'s union of device intervals,
copied, over the profiler's raw events.  The profiler's clock is tied to
the host's by an anchor: one small kernel launched, on an idle device,
right after `time.perf_counter()` is read (its launch latency, some
microseconds, is the error).
"""

from __future__ import annotations

import time

import torch


def _raw_events(prof):
    """(start_ns, end_ns, name) of every device activity of a profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out


def union(spans):
    """Merged, sorted (start, end) intervals of `spans`."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class DeviceTrace:
    """A CUDA-only profile of a window, with device spans on the host's
    `time.perf_counter()` clock."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.anchor_host = None
        self.spans = None  # (start_s, end_s, name) on the host clock

    def __enter__(self):
        self.prof.__enter__()
        marker = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        self.anchor_host = time.perf_counter()
        marker.fill_(0.0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        raw = _raw_events(self.prof)
        if raw:
            t0 = min(s for s, _, _ in raw)  # the anchor kernel
            self.spans = [((s - t0) * 1e-9 + self.anchor_host,
                           (e - t0) * 1e-9 + self.anchor_host, n) for s, e, n in raw]
        else:
            self.spans = []
        return False

    def busy_seconds(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] (host clock) in which some device activity ran."""
        busy = 0.0
        for s, e in union((max(s, lo), min(e, hi)) for s, e, _ in self.spans if e > lo and s < hi):
            busy += e - s
        return busy

    def idle_gaps(self, lo: float, hi: float):
        """The (start, end) gaps of [lo, hi] in which the device ran nothing."""
        gaps, cur = [], lo
        for s, e in union((max(s, lo), min(e, hi)) for s, e, _ in self.spans if e > lo and s < hi):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        return gaps

    def device_ops(self, lo: float, hi: float, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        tot: dict = {}
        for s, e, n in self.spans:
            if e > lo and s < hi:
                tot[n] = tot.get(n, 0.0) + (e - s)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], sec] for n, sec in rows]


class DecodeTimer:
    """Wraps the decode layer's entries (`nussinov_cuda.decode`,
    `nw_cuda.decode`) for a traced window: CUDA events around each call and
    the shapes and lengths it was given.  The events bracket the whole call,
    so a launch gap on an idle device counts as decode time."""

    def __init__(self):
        self.calls = []  # (kind, inputs, ev0, ev1)
        self._undo = []

    def install(self):
        from dafs_tpu_torch.ops import nussinov_cuda, nw_cuda

        for mod, kind in ((nussinov_cuda, "nussinov"), (nw_cuda, "nw")):
            self._wrap(mod, kind)

    def _wrap(self, mod, kind):
        orig = mod.decode

        def decode(*args):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = orig(*args)
            ev1.record()
            if kind == "nussinov":
                sm, lens = args
                inputs = (lens, sm.shape[1])
            else:
                sm, env_first, env_last, l1, _ = args
                inputs = (env_first, env_last, l1, sm.shape[1])
            self.calls.append((kind, inputs, ev0, ev1))
            return out

        mod.decode = decode
        self._undo.append((mod, orig))

    def uninstall(self):
        for mod, orig in self._undo:
            mod.decode = orig
        self._undo = []

    def work(self):
        """[(kind, operations, bytes, device seconds)] of every call."""
        from portbench import roofline

        torch.cuda.synchronize()
        memo: dict = {}
        out = []
        for kind, inputs, ev0, ev1 in self.calls:
            key = (kind, *map(id, inputs[:-1]), inputs[-1])
            if key not in memo:
                host = [t.cpu().numpy() for t in inputs[:-1]]
                memo[key] = (roofline.nussinov_work(host[0], inputs[-1]) if kind == "nussinov"
                             else roofline.nw_work(*host, inputs[-1]))
            ops, nbytes = memo[key]
            out.append((kind, ops, nbytes, ev0.elapsed_time(ev1) * 1e-3))
        return out
