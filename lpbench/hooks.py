"""Spans and launch records taken from the benchmark's own wrappers around
the program's functions, named ``"package.module:attr"`` or
``"package.module:Class.method"``.

A span wrapper synchronizes the card on entry and on exit and adds the
host-clock seconds between to its label, so it perturbs the pipeline: it is
installed in set-up (where nothing overlaps anyway) and in the traced run's
span call only, never in the measured window.  A launch record keeps what a
metric's ``describe(args, kwargs)`` says of each call of a kernel wrapper
(its shapes), in call order, without a synchronize.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time


def _resolve(target: str):
    """(owner object, attribute name) of ``"module:attr"`` or
    ``"module:Class.attr"``."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


@contextlib.contextmanager
def patched(wrappers: dict):
    """Install ``{target: make_wrapper}`` (each ``make_wrapper(original)``
    returns the replacement) for the duration of the block."""
    saved = []
    try:
        for target, make in wrappers.items():
            owner, name = _resolve(target)
            original = getattr(owner, name)
            saved.append((owner, name, original))
            setattr(owner, name, make(original))
        yield
    finally:
        for owner, name, original in reversed(saved):
            setattr(owner, name, original)


def span_wrappers(spans: dict, acc: dict, sync) -> dict:
    """Wrappers for ``{label: target}`` that add (seconds, calls) to
    ``acc[label]``; ``sync()`` waits for the device."""

    def make(label):
        def wrap(fn):
            @functools.wraps(fn)
            def timed(*args, **kwargs):
                sync()
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    sync()
                    sec, calls = acc.get(label, (0.0, 0))
                    acc[label] = (sec + time.perf_counter() - t, calls + 1)
            return timed
        return wrap

    return {target: make(label) for label, target in spans.items()}


def launch_wrappers(launches: dict, acc: dict) -> dict:
    """Wrappers for ``{target: describe}`` that append
    ``describe(args, kwargs)`` to ``acc[target]`` on every call."""

    def make(target, describe):
        def wrap(fn):
            @functools.wraps(fn)
            def recorded(*args, **kwargs):
                acc.setdefault(target, []).append(describe(args, kwargs))
                return fn(*args, **kwargs)
            return recorded
        return wrap

    return {target: make(target, d) for target, d in launches.items()}
