"""The port's checkpoint and command line against the JAX package's, on the CPU.

Counterpart of tests/test_aux.py::TestCheckpoint and ::TestCLI and of
tests/test_trace.py's CLI trace tests: a solver state through
``utils/checkpoint.py`` (bit-equal, the template's dtype and device, a shape
that does not fit), a warm start from a checkpoint with the JAX package's
counts, and ``python -m cholesky_is_magic_tpu_torch`` beside
``python -m cholesky_is_magic_tpu`` on the same arguments (plus
``--device cpu``), each JAX run shared by the cases that read it.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.__main__ import main as jax_main
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.solvers import PDASConfig as JPDASConfig
from cholesky_is_magic_tpu.solvers import make_pdas as j_make_pdas
from cholesky_is_magic_tpu.solvers import pdas as j_pdas
from cholesky_is_magic_tpu_torch.__main__ import main
from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
from cholesky_is_magic_tpu_torch.solvers.pdas import PDASConfig, make_pdas, pdas
from cholesky_is_magic_tpu_torch.utils import checkpoint, lanes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SIMPLE = os.path.join(FIXTURES, "simple.mps")
AFIRO = os.path.join(FIXTURES, "afiro.mps")
MAXRANGE = os.path.join(FIXTURES, "maxrange.mps")
AFIRO_OPTIMUM = -464.75314285714285


def _lp(pad=8, path=SIMPLE):
    sf = cimt.to_standard_form(cimt.read_mps_file(path))
    return to_device_lp(sf, pad_multiple=pad, dtype=torch.float64, device="cpu")


def _mid_state(lp, iters):
    """A pdas state carrying the iterates after ``iters`` iterations
    (tests/test_aux.py:45-51)."""
    st = make_pdas(lp)
    res = pdas(st, PDASConfig(max_iters=iters))
    return dataclasses.replace(st, x=res.x, y=res.extra["y"], w=res.extra["w"],
                               z=res.extra["z"]), res


class TestCheckpoint:
    def test_save_load_roundtrip_is_bit_equal(self, tmp_path):
        lp = _lp()
        mid, _ = _mid_state(lp, 5)
        path = str(tmp_path / "ckpt")
        checkpoint.save(path, mid)
        checkpoint.save(path, mid)  # an older checkpoint there is replaced
        restored = checkpoint.load(path, make_pdas(lp))
        got, _ = lanes.flatten(restored)
        want, _ = lanes.flatten(mid)
        assert len(got) == len(want) > 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        assert (restored.lp.m, restored.lp.n) == (mid.lp.m, mid.lp.n)

    def test_load_takes_the_templates_dtype_and_device(self, tmp_path):
        lp = _lp()
        mid, _ = _mid_state(lp, 5)
        path = str(tmp_path / "ckpt")
        checkpoint.save(path, mid)
        leaves, rebuild = lanes.flatten(make_pdas(lp))
        f32 = checkpoint.load(path, rebuild([
            t.to(torch.float32) if t.is_floating_point() else t for t in leaves]))
        assert f32.x.dtype == torch.float32 and f32.lp.col_mask.dtype == torch.bool
        assert torch.equal(f32.x, mid.x.to(torch.float32))
        meta = checkpoint.load(path, rebuild([t.to("meta") for t in leaves]))
        assert meta.x.device.type == "meta" and meta.lp.A.device.type == "meta"

    def test_a_shape_that_does_not_fit_raises(self, tmp_path):
        path = str(tmp_path / "ckpt")
        checkpoint.save(path, _mid_state(_lp(pad=8), 5)[0])
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load(path, make_pdas(_lp(pad=16)))

    def test_warm_start_from_a_checkpoint_takes_the_jax_counts(self, tmp_path):
        """tests/test_aux.py:59-74 in both packages: the JAX package's
        checkpoint round trip is the identity, so its warm state is built
        directly; the port's goes through save and load."""
        lp = _lp()
        final, cold = _mid_state(lp, 200)
        path = str(tmp_path / "warm")
        checkpoint.save(path, final)
        restored = checkpoint.load(path, make_pdas(lp))
        warm = pdas(make_pdas(lp, warm=restored), PDASConfig(max_iters=200))

        jsf = cim.to_standard_form(cim.read_mps_file(SIMPLE))
        jlp = j_to_device_lp(jsf, pad_multiple=8, dtype=jnp.float64)
        jcold = j_pdas(j_make_pdas(jlp), JPDASConfig(max_iters=200))
        jfinal = dataclasses.replace(j_make_pdas(jlp), x=jcold.x, y=jcold.extra["y"],
                                     w=jcold.extra["w"], z=jcold.extra["z"])
        jwarm = j_pdas(j_make_pdas(jlp, warm=jfinal), JPDASConfig(max_iters=200))

        assert int(cold.iterations) == int(jcold.iterations)
        assert int(warm.iterations) == int(jwarm.iterations)
        assert int(warm.iterations) <= int(cold.iterations)
        assert float(warm.objective) == pytest.approx(-7.0, abs=1e-3)


# The CLI cases: each runs once in each package (``--device cpu`` added for
# the port).  simple.mps also prints the symbolic report and the trace.
_F64 = ["--f64", "--pad", "16", "--json"]
CASES = {
    **{f"simple-{s}": [SIMPLE, "--solver", s, *_F64, "--report", "--trace"]
       for s in ("pdas", "pdas_dd", "affine", "alm")},
    **{f"afiro-{s}": [AFIRO, "--solver", s, *_F64]
       for s in ("pdas", "pdas_dd", "affine", "alm")},
    "maxrange-pdas": [MAXRANGE, *_F64],
    "afiro-presolve-pdas_dd": [AFIRO, "--solver", "pdas_dd", "--presolve", *_F64],
}


def _run_cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def cli():
    runs = {}

    def run(case):
        if case not in runs:
            argv = CASES[case]
            runs[case] = (_run_cli(jax_main, argv),
                          _run_cli(main, argv + ["--device", "cpu"]))
        return runs[case]

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_cli_json_matches_the_jax_package(case, cli):
    jax_lines, lines = cli(case)
    want, got = json.loads(jax_lines[-1]), json.loads(lines[-1])
    assert set(got) == set(want)
    assert got["solver"] == want["solver"]
    assert got["status"] == want["status"] == "optimal"
    objectives = [k for k in ("objective", "value", "original_objective") if k in want]
    assert objectives
    if want["solver"] == "affine":
        # f64 affine's end game follows rounding in both packages (ROADMAP
        # §3 item 2; tests/test_torch_affine.py drives the two in lockstep
        # to JAX's count): the counts part by up to 2 on these fixtures,
        # the objectives agree within 1e-8.
        assert abs(got["iterations"] - want["iterations"]) <= 2
        rel = 1e-8
    else:
        for k in ("iterations", "phase1_iterations", "outer_iterations"):
            assert got.get(k) == want.get(k), k
        rel = 1e-9
    for k in objectives:
        assert got[k] == pytest.approx(want[k], rel=rel), k
    if case == "maxrange-pdas":
        assert got["original_objective"] == pytest.approx(-got["objective"], rel=1e-15)
    if case == "afiro-presolve-pdas_dd":
        assert got["presolve"] == want["presolve"]
        assert "49" in got["presolve"]


def _trace_keys(lines):
    return [[cell.split("=")[0] for cell in ln.split()[2:]]
            for ln in lines if ln.startswith("iter ")]


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("simple-")])
def test_cli_report_and_trace_match_the_jax_package(case, cli):
    jax_lines, lines = cli(case)
    assert lines[:4] == jax_lines[:4]
    assert lines[0].startswith("AA':") and lines[1].startswith("Factor:")
    keys, jax_keys = _trace_keys(lines), _trace_keys(jax_lines)
    summary = json.loads(lines[-1])
    count = summary["outer_iterations" if "outer_iterations" in summary else "iterations"]
    assert keys and len(keys) == count
    if not case.endswith("affine"):  # affine's count: ROADMAP §3 item 2
        assert len(keys) == len(jax_keys)
    assert keys[0] == jax_keys[0] and all(k == keys[0] for k in keys)


def test_python_dash_m_runs_without_jax():
    """A real ``python -m cholesky_is_magic_tpu_torch`` process: exit 0,
    afiro's optimum, and no module of jax or of the JAX package imported
    (``-X importtime`` lists every import of the process)."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "cholesky_is_magic_tpu_torch",
         AFIRO, "--solver", "pdas_dd", *_F64, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["status"] == "optimal"
    assert payload["objective"] == pytest.approx(AFIRO_OPTIMUM, rel=1e-7)
    imported = [ln.rsplit("|", 1)[1].strip() for ln in out.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    roots = {name.split(".")[0] for name in imported}
    assert "cholesky_is_magic_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "cholesky_is_magic_tpu"}


def test_cli_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks what happens on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([SIMPLE, "--solver", "pdas"])
