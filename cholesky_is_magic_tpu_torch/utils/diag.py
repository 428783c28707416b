"""Diagnostics: factorization reports, checked mode, resource accounting.

Counterpart of ``cholesky_is_magic_tpu/utils/diag.py``, with the same names
and signatures.  The reference's observability is format-to-stdout traces
plus CHOLMOD's counters (SURVEY.md §5): a one-time "AA' nnz/flops, Factor
nnz/flops" report (affine-scaling.lisp:273-279), the solve-kkt-newton-check
runtime verifier (sparse-newton-solve.lisp:200-223) and malloc-count /
memory-inuse leak checks (:256-258).  Here:

- :func:`factor_report` — the same cost report from a FactorPlan, the JAX
  package's text character for character;
- :func:`checked_solve_kkt_newton` — raises :class:`KKTCheckError` when a
  KKT residual is not below tolerance (the assert analogue);
- :func:`condition_number` / :class:`WorstConditionTracker` — the dense KKT
  solver's conditioning probe;
- :func:`device_memory_report` — the CUDA caching allocator's statistics
  (the cholmod-get-memory-inuse analogue); :func:`live_buffer_report` — the
  tensors Python still holds (the malloc-count analogue, standing in for
  ``jax.live_arrays()``); :func:`memory_map_count` — the process's memory
  mappings;
- :func:`nan_debug` — every operator's floating output checked for NaN, as
  ``jax_debug_nans`` does (the numerical "sanitizer" mode);
- :func:`profile_trace` / :func:`annotate` — ``torch.profiler`` around a
  block, with labelled regions, written as a TensorBoard trace;
- :func:`recording` / :func:`span` / :func:`count` — where a solve's time
  goes, layer by layer: the spans the solvers open at their layer
  boundaries and the counters they keep, recorded on the host's wall
  clock (``time.time_ns()``, the clock ``torch.profiler`` stamps its
  events on) while a ``recording()`` block is open, and nothing otherwise.

Seeing where a solve's time goes::

    with diag.recording() as rec:
        rep = cimt.solve("problem.mps", "pdas_dd")
    for name, (calls, sec, own) in sorted(rec.totals().items()):
        print(f"{name}: {calls} calls, {sec:.3f} s, {own:.3f} s of its own")
    print(rec.counts, rec.launches)

``rec.spans`` holds each span (name, parent index, entry and exit in ns),
``rec.counts`` the counters, ``rec.launches`` the hand-written kernels'
launches over the block.  The spans are host time: the card runs behind
the host, so a span that issues work ends before its work does.  To put
the card's time down to the spans, profile the same block and give each
kernel to the span open when its runtime call (``cudaLaunchKernel``, by
correlation id) started, as the benchmark's ``lpbench/program_spans.py``
does.  The spans:

- ``loop.iteration``: one iteration of a pdas / pdas_dd loop, single or
  batched (``solvers/pdas.py::_lane_loop``); its own time, less its
  ``normal.*`` children, is the iteration's step;
- ``normal.assemble``: the normal matrix (dense: the scaled SGEMM; the
  tile engine: the pair-schedule assembly or the dense-A tile products);
- ``normal.factorize``: each factorization (the dbound retry's second one
  too; the dense "inverse" method's triangular inverse);
- ``normal.solve``: each raw solve (two triangular solves, or the tile
  engine's blocked substitutions with its permutation);
- ``normal.refine``: each refinement or PCG step's residual products;
- ``factorize.tile``, ``factorize.trsm``, ``factorize.schur``: inside a
  tile engine's ``normal.factorize``, per panel, its tile factor (K1), its
  TRSM, and its Schur update (the SYRK operands' gathers, the batched
  products and the ``index_add_``);
- ``ops.bell.matvec``, ``ops.bell.dd_matvec``, ``ops.ell.matvec``,
  ``ops.ell.dd_matvec``: the sparse path's block-ELL and ELL products;
- ``setup.lane_state`` (a fully sparse state, ``make_pdas_sparse`` and
  ``make_affine_state_sparse``), ``setup.analysis`` (the tile engine's
  build, ``engine_for_sparse``), ``setup.embed`` (``api.embed_batch``).

The counters: ``loop.iterations``, ``loop.host_reads`` (each read of a
device tensor on the host in the loops and the normal solves they call),
``normal.factorizations``, ``normal.solves``, and per tile-engine
factorization ``normal.trsm_tiles`` and ``normal.schur_products`` (one
lane's TRSM tiles and Schur-update tile products, summed over the panels).

``release_jit_maps`` is not ported: it drops XLA's compiled-executable
caches to keep a process under the kernel's map-count limit, and the port
compiles no XLA programs.  Its kernels are one shared library keyed by a
hash of their sources (``ops/cuda_build.py``), loaded once per process.
"""

from __future__ import annotations

import contextlib
import gc
import os

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from cholesky_is_magic_tpu_torch.kkt import newton as kkt_newton
from cholesky_is_magic_tpu_torch.utils import spans as _spans
from cholesky_is_magic_tpu_torch.utils.spans import (  # noqa: F401  (re-exported)
    Recording,
    Span,
    count,
    recording,
    span,
)


def factor_report(plan) -> str:
    """The reference's startup cost report (affine-scaling.lisp:273-279):

        AA':    nnz: ...  flops: ...
        Factor: nnz: ...  flops: ...
    """
    aat_flops = 2.0 * plan.nnz_N  # one multiply-add per stored entry per rhs
    stats = plan.stats()
    lines = [
        f"AA':    nnz: {plan.nnz_N:12.5g} flops: {aat_flops:12.5g}",
        f"Factor: nnz: {plan.nnz_L:12.5g} flops: {plan.flops:12.5g}",
        f"Tiles:  {stats['nonzero_tiles']}/{stats['total_tiles']} "
        f"({plan.block}x{plan.block}), supernodes: {len(plan.snodes)}",
    ]
    if "aligned_tiles" in stats:
        # Supernode-aligned (slot-grid) residency: tile residency is
        # etree-exact (no closure), so this IS the engine's working set.
        dense_elems = plan.nnz_L if plan.nnz_L else 1
        lines.append(
            f"Aligned: {stats['aligned_tiles']} tiles over "
            f"{stats['aligned_panels']} panels "
            f"({stats['aligned_tiles'] * plan.block * plan.block / dense_elems:.2f}x "
            f"the elementwise nnz_L)"
        )
    return "\n".join(lines)


class KKTCheckError(ValueError):
    """A checked KKT solve whose residuals are not below tolerance; a
    ValueError, as the JAX package's checkify error is."""

    def __init__(self, residuals: torch.Tensor, tol: float):
        self.residuals = residuals
        super().__init__(f"KKT residuals {residuals.tolist()} exceed tolerance {tol}")


def checked_solve_kkt_newton(sl, su, w, z, op, e, f, g, h, tol: float = 1e-4):
    """Runtime-verified KKT solve: raises :class:`KKTCheckError` unless every
    block residual is below ``tol``.

    The rendering of solve-kkt-newton-check's asserts
    (sparse-newton-solve.lisp:200-223).  The test is ``all(res < tol)``, as
    the JAX package's checkify check is, so a NaN residual (a singular
    system) raises too.  It costs one host read of the four residuals.
    """
    deltas = kkt_newton.solve_kkt_newton(sl, su, w, z, op, e, f, g, h)
    res = kkt_newton.kkt_residuals(sl, su, w, z, op, e, f, g, h, deltas)
    if not bool(torch.all(res < tol)):
        raise KKTCheckError(res.cpu(), tol)
    return deltas


def condition_number(N: torch.Tensor) -> torch.Tensor:
    """sigma_max / sigma_min of a (normal) matrix via SVD — the dense KKT
    solver's conditioning probe (cond-number, newton-solve.lisp:100-110).
    Expensive (full SVD); for monitoring, not the hot loop."""
    s = torch.linalg.svdvals(N)
    return s[0] / s[-1]


class WorstConditionTracker:
    """Host-side running maximum — *worst-condition-number*
    (newton-solve.lisp:100, reported by the test sweep at :202)."""

    def __init__(self):
        self.worst = 1.0

    def update(self, N: torch.Tensor) -> float:
        c = float(condition_number(N))
        self.worst = max(self.worst, c)
        return c


def device_memory_report(device=None) -> dict:
    """Allocator statistics for one device — the cholmod-get-memory-inuse
    analogue.  On a CUDA device: ``torch.cuda.memory_stats`` plus the JAX
    package's keys where PyTorch has the same quantity: ``bytes_in_use``
    and ``peak_bytes_in_use`` (the bytes the allocator has handed to
    tensors, now and at most) and ``bytes_limit`` (the card's memory).
    Empty on the CPU, as in the JAX package.  ``device`` None is the current
    CUDA device where there is one, else the CPU (JAX's first device)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.mem_get_info(device)[1]
    return stats


def live_buffer_report() -> dict:
    """Count and bytes of the tensor storages Python still holds — the
    malloc-count analogue (a solver that keeps growing this across solves is
    leaking references).  Each storage counts once: views share one.
    Tensors held only by native code (a CUDA graph's pool) are not seen."""
    seen = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): a deprecated module proxy warns when
        # its __class__ is read.
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):  # no storage (meta, wrapped)
            continue
        seen[(str(st.device), st.data_ptr(), st.nbytes())] = st.nbytes()
    return {"count": len(seen), "bytes": int(sum(seen.values()))}


def memory_map_count() -> int:
    """Number of memory mappings held by this process (Linux; -1
    elsewhere).  The kernel caps it (vm.max_map_count, 65,530 by default);
    a long-lived process that keeps mapping code or buffers creeps toward
    it."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return -1


_NAN_DEBUG = {"enabled": False}


_ALLOCATIONS = frozenset(
    getattr(torch.ops.aten, name) for name in
    ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"))


class _NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError on any floating operator output that holds
    a NaN while nan_debug is on.  An allocation's output (``torch.empty``
    and its kin) is not read: it holds whatever the memory held, and its
    values are written before any operator reads them."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _NAN_DEBUG["enabled"] and func.overloadpacket not in _ALLOCATIONS:
            for t in pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                        and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Context manager turning NaN checks on (or, nested, off) for every
    operator PyTorch dispatches: the ``jax_debug_nans`` analogue.  Each
    floating output is read on the host, so it runs slowly and syncs the
    card at every operator.  The previous state comes back on exit, on an
    exception too; blocks nest.

    The check sits at PyTorch's dispatcher.  It sees the ``torch.library``
    operators behind the batched kernels (``cim::dd_mv``, ``cim::dd_rmv``,
    ``cim::factor_tile``, ``cim::assemble_pairs``) but not the single
    kernels' ctypes launches (``ops/dd_cuda.py``, ``ops/chol_cuda.py``,
    ``sparse/tiled_cuda.py``): a NaN one of them writes is caught at the
    next operator that reads it.
    """
    prev = _NAN_DEBUG["enabled"]
    _NAN_DEBUG["enabled"] = enable
    try:
        if enable:
            with _NaNCheck():
                yield
        else:
            yield
    finally:
        _NAN_DEBUG["enabled"] = prev


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace around a block and write it under
    ``logdir`` (created) in TensorBoard's layout
    (``<host>_<pid>.<time>.pt.trace.json``, a Chrome trace).  Yields the
    profiler (``key_averages()``, ``events()``).

    Usage::

        with diag.profile_trace("/tmp/lp-trace"):
            with diag.annotate("pdas_dd"):
                rep = cimt.solve(path, "pdas_dd")

    Records CPU activity, and CUDA activity when there is a card: each
    kernel launch is one event.  Inside the block every span
    (:func:`span`, the solvers' own at their layer boundaries and
    :func:`annotate`'s) is a labelled region of the trace.  A profiler that
    fails to start raises; it never drops to CPU only.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        with _spans.labelled():
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


# A named region: a span, which under profile_trace shows up labelled in
# the captured trace and under recording() is recorded.
annotate = span
