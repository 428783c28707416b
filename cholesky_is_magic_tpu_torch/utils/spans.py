"""Spans and counters of the solver's layers, on the host's wall clock.

The recorder behind ``utils.diag``'s :func:`span`, :func:`count` and
:func:`recording` (re-exported there; the hot-path modules import it from
here, since ``diag`` imports the KKT layer that imports them).

- ``span(name)``: a context manager (or decorator) around a layer's host
  code.  While a :func:`recording` is open it appends one :class:`Span`
  (name, the enclosing span's index, ``time.time_ns()`` at entry and at
  exit) to the recording; while ``diag.profile_trace`` runs it also opens a
  ``record_function`` of its name.  Otherwise, the default and the state of
  every timed run, it costs a read of one module global and a dict lookup
  that returns the name's shared no-op context: no allocation, no clock
  read.
- ``count(name, n=1)``: adds ``n`` to a counter of the open recording.
- :func:`host_bool`: ``bool(t)`` of a device tensor, counted as one
  ``loop.host_reads``.

A span never launches a kernel, never synchronizes and never touches a
tensor, so it behaves the same under ``torch.func.vmap`` (a vmapped layer's
Python runs once for all lanes: one span per batched call).  Spans record
where the host is; the device runs behind it, and a reader that wants the
device's time puts each kernel down to the span open when its launch was
issued (the profiler's runtime call, on the same clock).

The names the solvers open (``loop.*``, ``normal.*``, ``setup.*``, the
sparse products ``ops.*``) and the counters they add to are listed in
``utils/diag.py``'s docstring.  One thread records: spans opened on other
threads nest as if they were on the recording one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One closed span: its ``parent`` is the index of the span it opened
    inside (-1 at the top); stamps in ns of ``time.time_ns()``."""

    name: str
    parent: int
    t0_ns: int
    t1_ns: int


@dataclasses.dataclass
class Recording:
    """What one :func:`recording` block saw: its own stamps, the spans in
    the order they opened, the counters, and the kernel launches of the
    port's hand-written kernels over the block (the deltas of the
    ``LAUNCHES`` dicts of ``ops.dd_cuda``, ``ops.chol_cuda``,
    ``ops.bell_cuda`` and ``sparse.tiled_cuda``, by their keys)."""

    t0_ns: int = 0
    t1_ns: int = 0
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    _stack: list = dataclasses.field(default_factory=list, repr=False)
    _open: bool = dataclasses.field(default=True, repr=False)

    def self_ns(self) -> list:
        """Each span's own time: its duration less its children's."""
        own = [s.t1_ns - s.t0_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                own[s.parent] -= s.t1_ns - s.t0_ns
        return own

    def totals(self) -> dict:
        """``{name: (calls, seconds, self seconds)}`` over the spans."""
        out = {}
        for s, own in zip(self.spans, self.self_ns()):
            calls, total, mine = out.get(s.name, (0, 0.0, 0.0))
            out[s.name] = (calls + 1, total + (s.t1_ns - s.t0_ns) * 1e-9, mine + own * 1e-9)
        return out


class _Listening(NamedTuple):
    rec: Recording | None  # the open recording
    label: bool  # diag.profile_trace runs: open record_function too


_ON: _Listening | None = None  # None: nothing listens (the default)


class _Named:
    __slots__ = ("_name",)

    def __call__(self, fn):
        """As a decorator: a span of this name around each call, decided
        at the call."""
        import functools

        name = self._name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Named):
    """A name's shared no-op span."""

    __slots__ = ()

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _On(_Named):
    __slots__ = ("_on", "_rec", "_index", "_rf")

    def __init__(self, on: _Listening, name: str):
        self._name, self._on, self._rec, self._rf = name, on, on.rec, None

    def __enter__(self):
        rec = self._rec
        if rec is not None:
            self._index = len(rec.spans)
            rec.spans.append([self._name, rec._stack[-1] if rec._stack else -1,
                              time.time_ns(), 0])
            rec._stack.append(self._index)
        if self._on.label:
            import torch

            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = self._rec
        if rec is not None and rec._open:
            rec.spans[self._index][3] = time.time_ns()
            rec._stack.pop()
        return False


class _OffSpans(dict):
    def __missing__(self, name):
        off = self[name] = _Off(name)
        return off


_OFF = _OffSpans()


def span(name: str):
    """A span of ``name`` around a block (``with span(name):``) or around
    each call of a function (``@span(name)``); see the module docstring."""
    on = _ON
    if on is None:
        return _OFF[name]
    return _On(on, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open recording's counter ``name`` (nothing when no
    recording is open)."""
    on = _ON
    if on is not None and on.rec is not None:
        c = on.rec.counts
        c[name] = c.get(name, 0) + n


def host_bool(t) -> bool:
    """``bool(t)``: a read of a device tensor on the host, counted as one
    ``loop.host_reads``."""
    count("loop.host_reads")
    return bool(t)


def _launches() -> dict:
    from cholesky_is_magic_tpu_torch.ops import bell_cuda, chol_cuda, dd_cuda
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

    return {**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES, **bell_cuda.LAUNCHES,
            **tiled_cuda.LAUNCHES}


@contextlib.contextmanager
def recording():
    """Record every span and counter of the block; yields the
    :class:`Recording`, complete when the block ends.  The spans stay in
    memory until then.  A recording opened inside another takes over for
    its block (the outer one misses it)."""
    global _ON
    prev = _ON
    before = _launches()
    rec = Recording(t0_ns=time.time_ns())
    _ON = _Listening(rec, prev is not None and prev.label)
    try:
        yield rec
    finally:
        _ON = prev
        rec.t1_ns = time.time_ns()
        rec._open = False
        rec.spans = [Span(n, p, t0, t1 if t1 else rec.t1_ns) for n, p, t0, t1 in rec.spans]
        rec._stack = []
        after = _launches()
        rec.launches = {k: after[k] - before.get(k, 0) for k in after}


@contextlib.contextmanager
def labelled():
    """Every span of the block also opens a ``record_function`` of its
    name (``diag.profile_trace`` holds this open while its profiler
    records CPU activity)."""
    global _ON
    prev = _ON
    _ON = _Listening(prev.rec if prev is not None else None, True)
    try:
        yield
    finally:
        _ON = prev
