"""Spans and counters of the program's own work, on `time.perf_counter()`.

A span is a named interval of host time with its parent, the root span of
its family run, a few attributes and counters; the program opens them
where the work happens (`pipeline`, `dd`, `projection`, `ops/alifold`).
Recording is off unless a caller starts it:

    with spans.record() as recs:
        dafs.run(records)
    # recs: one `Span` per opened span, in the order they opened

Off, `span()` returns one shared context that does nothing and `count()`
and `recording()` return at once.  `timed()` always reads the clock (its
callers keep the seconds in their own results) and is recorded only while
recording is on.  Records stay in memory; `Span.as_dict()` gives a record
in a form `json` writes.  `torch.profiler`'s device intervals can be put
on the same clock (`portbench/trace.DeviceTrace` does), so a device idle
gap can be laid to the innermost span open over it.
"""

from __future__ import annotations

import contextlib
import functools
import time


class _State:
    """The list being filled (None when off) and the spans open in it,
    innermost last."""

    def __init__(self):
        self.records: list | None = None
        self.stack: list = []


_state = _State()


class Span:
    """One interval: `t0`/`t1` on `time.perf_counter()`, `parent` and
    `family` (the root span's) as ids, which are indices into the list
    `record()` fills; `id` is None for a span taken while recording was
    off."""

    __slots__ = ("id", "parent", "family", "name", "t0", "t1", "attrs", "counts")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.counts: dict = {}
        self.id = self.parent = self.family = None
        self.t0 = self.t1 = None

    def __enter__(self):
        recs = _state.records
        if recs is not None:
            stack = _state.stack
            self.id = len(recs)
            if stack:
                self.parent = stack[-1].id
                self.family = stack[-1].family
            else:
                self.family = self.id
            recs.append(self)
            stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        stack = _state.stack
        if self.id is not None and stack and stack[-1] is self:
            stack.pop()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span around the `with` block, which gets the `Span` (None when
    recording is off)."""
    if _state.records is None:
        return _NO_SPAN
    return Span(name, attrs)


def spanned(name: str, **attrs):
    """A decorator: every call of the function runs in `span(name, **attrs)`."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kw):
            with span(name, **attrs):
                return f(*args, **kw)
        return inner
    return wrap


def timed(name: str, **attrs) -> Span:
    """A span that reads the clock whether or not recording is on; the
    `with` block gets it, and `.seconds` after the block."""
    return Span(name, attrs)


def count(name: str, n=1) -> None:
    """Adds `n` to the counter `name` of the innermost open span."""
    stack = _state.stack
    if _state.records is None or not stack:
        return
    c = stack[-1].counts
    c[name] = c.get(name, 0) + n


def recording() -> bool:
    """Whether a `record()` block is open."""
    return _state.records is not None


@contextlib.contextmanager
def record():
    """Turns recording on for the `with` block, which gets the list of
    `Span`s it fills.  Recording does not nest."""
    if _state.records is not None:
        raise RuntimeError("spans are already being recorded")
    recs: list = []
    _state.records, _state.stack = recs, []
    try:
        yield recs
    finally:
        _state.records, _state.stack = None, []
