"""The Schur updates' yardstick (lpbench/schur.py) gives back the counts of
the issue's reckoning, and their readers read nothing from a program
without the spans and counters."""

import types

import pytest

from lpbench import program_spans as ps
from lpbench import roofline, schur
from cholesky_is_magic_tpu_torch.utils.spans import Recording, Span


def test_qap15_one_factorization_one_lane():
    # 14948 products and 1096 panel tiles at b = 128: 62.7 GFLOP, and
    # (1096 + 2 * 14948) tiles of 64 KiB = 2.03 GB; set by the operations.
    got = schur.update(1, 128, 14948, 1096)
    assert got["flops"] == 14948 * 2 * 128**3
    assert got["bytes"] == 4 * 128 * 128 * (1096 + 2 * 14948)
    assert got["by"] == "operations"
    assert got["ms"] == pytest.approx(62.70e9 / roofline.PEAK_FP32_FLOPS * 1e3, rel=1e-3)


def test_lanes_scale_both_and_a_product_is_bound_by_its_operations():
    one, many = schur.update(1, 128, 330, 318), schur.update(32, 128, 330, 318)
    assert many["flops"] == 32 * one["flops"] and many["bytes"] == 32 * one["bytes"]
    # One product with its panel tile: 4.2 MFLOP against 196 KB.
    assert schur.update(1, 128, 1, 1)["by"] == "operations"
    assert schur.update(1, 16, 1, 1)["by"] == "bytes"


MS = 1_000_000


def _run(counts, spans):
    rec = Recording(t0_ns=0, t1_ns=100 * MS, spans=spans, counts=counts)
    events = [("cudaLaunchKernel", False, 12 * MS, 13 * MS, 1), ("gemm", True, 13 * MS, 23 * MS, 1),
              ("cudaLaunchKernel", False, 40 * MS, 41 * MS, 2), ("k", True, 41 * MS, 45 * MS, 2)]
    cap = ps.Capture(recording=rec, events=events)
    ps._CACHE.clear()
    return types.SimpleNamespace(launches={ps.CLOSE: [cap], ps.WINDOW: [(0, 100 * MS)]},
                                 traced_iterations=2, lanes=2, traffic={"block": 128},
                                 log=[], say=lambda line: None)


SPANS = [Span("loop.iteration", -1, 0, 100 * MS), Span("normal.factorize", 0, 10 * MS, 50 * MS),
         Span("factorize.schur", 1, 11 * MS, 20 * MS)]


def test_the_readers_on_a_recorded_call():
    from lpbench.metrics import schur_busy_ms_per_iter as busy
    from lpbench.metrics import schur_products_per_iter as products
    from lpbench.metrics import schur_update_roofline as share

    counts = {"loop.iterations": 2, schur.PRODUCTS: 600, schur.PANEL_TILES: 40}
    run = _run(counts, SPANS)
    assert busy.read(run) == pytest.approx(5.0)  # 10 ms over 2 iterations
    assert products.read(run) == 300
    want = 100 * schur.update(2, 128, 600, 40)["ms"] / 10.0
    assert share.read(run) == pytest.approx(want)
    # A program without the spans and counters: nothing, and no error.
    for reader in (busy, products, share):
        assert reader.read(_run({"loop.iterations": 2}, SPANS[:2])) is None
