"""The traced call put down to the program's own spans.

The program records its spans (``utils.diag.recording()``: name, parent,
entry and exit on ``time.time_ns()``) while the profiler records the card
(:mod:`lpbench.trace`, on the same clock).  Per innermost span, that is
the span open on the host with no child open inside it at that moment:

- **busy**: the device time of every kernel, copy and fill whose CUDA
  runtime call (its launch, by correlation id) started inside the span;
- **idle**: each idle gap of the window (as :func:`lpbench.trace.reduce`
  finds them), put down to the span open on the host at the gap's middle;
- **host self time**: the span's duration less its children's.

Device time whose runtime call is not in the trace, or started outside
every span, and idle outside every span, are kept apart under
:data:`UNMATCHED` and :data:`OUTSIDE`, so that busy sums to the device
total and idle to the window's idle.  :func:`by_layer` rolls the spans up
to the solver's layers (:data:`LAYERS`): each span goes to its nearest
enclosing layer span, itself included; ``loop.iteration``'s share is then
the iteration's step, its time less its ``normal.*`` children's.

The harness knows nothing of the program's recorder: the metrics that read
it take it through the harness's launch records (:data:`LAUNCHES`, the
``{target: describe}`` that a metric declares, each ``describe`` called
before its target in the traced call).  :func:`_open` opens the recorder as
:func:`lpbench.trace.traced` starts; :func:`_close` closes it once the
profiler has stopped, as ``traced`` hands the profiler to
:func:`lpbench.trace._events`, and keeps every event with its correlation
id; :func:`_window` keeps the window that ``traced`` hands to
:func:`lpbench.trace.reduce`.  A program without ``diag.recording`` gives
nothing, and the metrics leave themselves out of the line.
"""

from __future__ import annotations

import bisect
import dataclasses

from lpbench import program
from lpbench import trace as tracing

LAYERS = ("normal.assemble", "normal.factorize", "normal.solve", "normal.refine",
          "loop.iteration")
OUTSIDE = "(no span)"
UNMATCHED = "(no runtime call)"


@dataclasses.dataclass
class Timeline:
    """The traced window's device intervals, runtime calls and idle gaps,
    each on the profiler's (wall) clock in ns."""

    t0_ns: int
    t1_ns: int
    device: list  # (name, start_ns, end_ns, correlation id), clipped to the window
    runtime: list  # (name, start_ns, end_ns, correlation id) of the CUDA runtime calls
    gaps: list  # (start_ns, end_ns) with no device interval
    window_s: float
    busy_s: float


def timeline(events, t0_ns: int, t1_ns: int) -> Timeline:
    """The :class:`Timeline` of ``events`` ((name, is_device, start_ns,
    end_ns, correlation id)) in [t0_ns, t1_ns]: the device intervals, busy
    time and gaps of :func:`lpbench.trace.reduce` on the same events."""
    dev = [(n, max(s, t0_ns), min(e, t1_ns), c) for n, d, s, e, c in events
           if d and e > t0_ns and s < t1_ns]
    runtime = [(n, s, e, c) for n, d, s, e, c in events
               if not d and n.startswith("cu") and e > t0_ns and s < t1_ns]
    busy = tracing._union((s, e) for _, s, e, _ in dev)
    gaps, prev = [], t0_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    return Timeline(t0_ns=t0_ns, t1_ns=t1_ns, device=dev, runtime=runtime, gaps=gaps,
                    window_s=(t1_ns - t0_ns) * 1e-9,
                    busy_s=sum(e - s for s, e in busy) * 1e-9)


def events(prof) -> list:
    """(name, is_device, start_ns, end_ns, correlation id) of every event of
    a stopped ``torch.profiler.profile`` (the id None where this PyTorch
    gives none)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        corr = e.correlation_id() if hasattr(e, "correlation_id") else None
        out.append((e.name(), e.device_type() == cuda, start, start + e.duration_ns(), corr))
    return out


@dataclasses.dataclass
class Capture:
    """The program's recording of the traced call and the profiler's events."""

    recording: object
    events: list


_OPEN = []  # the recorder's block opened as the traced call started


def _open(args, kwargs):
    """Before ``lpbench.trace.traced``: open the program's recorder."""
    while _OPEN:  # a block a failed call left open
        _OPEN.pop()[0].__exit__(None, None, None)
    try:
        make = getattr(program.mod("utils.diag"), "recording", None)
    except ImportError:
        make = None
    if make is not None:
        block = make()
        _OPEN.append((block, block.__enter__()))


def _close(args, kwargs):
    """Before ``lpbench.trace._events(prof)``, the profiler stopped: close
    the recorder; the :class:`Capture`, or None without a recorder."""
    if not _OPEN:
        return None
    block, rec = _OPEN.pop()
    block.__exit__(None, None, None)
    prof = args[0] if args else kwargs["prof"]
    return Capture(recording=rec, events=events(prof))


def _window(args, kwargs):
    """Before ``lpbench.trace.reduce(events, t0_ns, t1_ns)``: the window."""
    t0, t1 = (args[1], args[2]) if len(args) >= 3 else (kwargs["t0_ns"], kwargs["t1_ns"])
    return int(t0), int(t1)


OPEN, CLOSE, WINDOW = "lpbench.trace:traced", "lpbench.trace:_events", "lpbench.trace:reduce"
LAUNCHES = {OPEN: _open, CLOSE: _close, WINDOW: _window}


@dataclasses.dataclass
class Share:
    """Seconds put down to one span name (or layer)."""

    busy_s: float = 0.0
    idle_s: float = 0.0
    self_s: float = 0.0
    calls: int = 0


def innermost(spans) -> tuple[list, list]:
    """(bounds, owner): from ``bounds[k]`` to ``bounds[k + 1]`` the
    innermost open span is ``owner[k]`` (its index; -1: none).  Spans come
    in the order they opened, properly nested."""
    bounds, owner, stack = [], [], []

    def close_until(t):
        while stack and spans[stack[-1]].t1_ns <= t:
            top = stack.pop()
            bounds.append(spans[top].t1_ns)
            owner.append(stack[-1] if stack else -1)

    for i, s in enumerate(spans):
        close_until(s.t0_ns)
        stack.append(i)
        bounds.append(s.t0_ns)
        owner.append(i)
    close_until(float("inf"))
    return bounds, owner


def _at(bounds, owner, t) -> int:
    k = bisect.bisect_right(bounds, t) - 1
    return owner[k] if k >= 0 else -1


def _attribute(tl, rec, key) -> dict:
    """``{key(span index): Share}`` of busy and idle (index -1: no span open),
    with :data:`UNMATCHED`."""
    bounds, owner = innermost(rec.spans)
    out = {}

    def share(k):
        if k not in out:
            out[k] = Share()
        return out[k]

    launched = {c: s for _, s, _, c in tl.runtime if c is not None}
    for _, s, e, c in tl.device:
        t = launched.get(c) if c is not None else None
        share(UNMATCHED if t is None else key(_at(bounds, owner, t))).busy_s += (e - s) * 1e-9
    for gs, ge in tl.gaps:
        share(key(_at(bounds, owner, (gs + ge) // 2))).idle_s += (ge - gs) * 1e-9
    return out


def reduce(tl, rec) -> dict:
    """``{span name: Share}`` of the traced call, with :data:`OUTSIDE` and
    :data:`UNMATCHED`; ``tl`` a :class:`Timeline`, ``rec`` the
    program's recording of the same call."""
    spans = rec.spans
    out = _attribute(tl, rec, lambda i: spans[i].name if i >= 0 else OUTSIDE)
    for s, own in zip(spans, rec.self_ns()):
        sh = out.setdefault(s.name, Share())
        sh.self_s += own * 1e-9
        sh.calls += 1
    return out


def layer_of(spans, i: int) -> str:
    """The nearest layer span enclosing span ``i`` (itself included), or
    :data:`OUTSIDE`."""
    while i >= 0:
        if spans[i].name in LAYERS:
            return spans[i].name
        i = spans[i].parent
    return OUTSIDE


def by_layer(tl, rec) -> dict:
    """``{layer: Share}`` (busy and idle) with :data:`OUTSIDE` and
    :data:`UNMATCHED`: :func:`reduce` rolled up to :data:`LAYERS`."""
    out = {k: Share() for k in (*LAYERS, OUTSIDE, UNMATCHED)}
    out.update(_attribute(tl, rec, lambda i: layer_of(rec.spans, i)))
    return out


_CACHE = {}


def traced(run):
    """``(Timeline, Recording)`` of a run's traced call, once per run, the
    ``[trace] by span:`` and ``[trace] counters:`` lines said on its log;
    None where the program has no recorder or the call was not traced."""
    caps = [c for c in run.launches.get(CLOSE, []) if c is not None]
    windows = run.launches.get(WINDOW, [])
    if not caps or not windows or run.traced_iterations <= 0:
        return None
    cap = caps[-1]
    if _CACHE.get("capture") is not cap:
        _CACHE.clear()
        tl = timeline(cap.events, *windows[-1])
        rec = cap.recording
        run.say(line(tl, rec, run.traced_iterations))
        run.say(f"[trace] counters: {rec.counts}; hand-written kernel launches:"
                f" { {k: v for k, v in rec.launches.items() if v} }")
        _CACHE.update(capture=cap, got=(tl, rec), layers=None)
    return _CACHE["got"]


def layers(run) -> dict | None:
    """:func:`by_layer` of a run's traced call, once per run; None where the
    run has no recording or no device interval to put down."""
    got = traced(run)
    if got is None or got[0].busy_s <= 0.0:
        return None
    if _CACHE["layers"] is None:
        _CACHE["layers"] = by_layer(*got)
    return _CACHE["layers"]


def busy_ms_per_iter(run, layer: str) -> float | None:
    got = layers(run)
    return None if got is None else 1e3 * got[layer].busy_s / run.traced_iterations


def idle_ms_per_iter(run, layer: str) -> float | None:
    got = layers(run)
    return None if got is None else 1e3 * got[layer].idle_s / run.traced_iterations


def count_per_iter(run, counter: str) -> float | None:
    """A counter of the traced call's recording over the loops' iterations;
    None where the program keeps no loop counters."""
    got = traced(run)
    if got is None or "loop.iterations" not in got[1].counts:
        return None
    return got[1].counts.get(counter, 0) / run.traced_iterations


def line(tl, rec, iterations: int) -> str:
    """The ``[trace] by span:`` line: per innermost span name, device busy,
    idle and host self ms per iteration and its calls, busiest first; then
    the same rolled up to the layers, beside the device's summed time and
    the window's idle, which they add up to."""
    got = reduce(tl, rec)
    launched = {r[3] for r in tl.runtime}
    matched = sum(1 for *_, c in tl.device if c is not None and c in launched)
    it = max(iterations, 1)
    parts = [f"{k} busy {1e3 * v.busy_s / it:.4f} idle {1e3 * v.idle_s / it:.4f}"
             f" self {1e3 * v.self_s / it:.4f} ms/iter, {v.calls} calls"
             for k, v in sorted(got.items(), key=lambda kv: -kv[1].busy_s)]
    layers = [f"{k} busy {1e3 * v.busy_s / it:.4f} idle {1e3 * v.idle_s / it:.4f}"
              for k, v in by_layer(tl, rec).items()]
    device = sum(e - s for _, s, e, _ in tl.device) * 1e-6 / it
    idle = (tl.window_s - tl.busy_s) * 1e3 / it
    return (f"[trace] by span: {len(tl.device)} device intervals, {matched} matched to"
            f" their runtime call; {iterations} iterations; " + "; ".join(parts)
            + " || by layer (ms/iter): " + "; ".join(layers)
            + f" || device summed {device:.4f}, idle {idle:.4f} ms/iter")
