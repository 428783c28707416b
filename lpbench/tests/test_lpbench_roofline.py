"""The yardstick gives back the bounds the kernel table of PERF.md was
measured against, and a kernel that meets its bound reads 100%, never
more."""

import types

import pytest

from lpbench import roofline, trace

# The m = 16384 staircase at block 128 (seed 0, the smoke's phase 8 LP):
# its engine's pair schedule as the assembly kernel reads it, the pair
# weights (f32) and the 32-bit columns, run starts, run destinations, run
# rows and chunk starts.
M16K = dict(n_pairs=865026, n_d=49152, n_boost=16384, tiles=270, b=128,
            schedule_bytes=4 * (865026 + 865026 + 316676 + 316675 + 316675 + 2161))


def test_dd_mv_batched_long_rows():
    # Row 1b at (8, 1536, 5120): 0.0752 ms, set by the bytes.
    b = roofline.dd_mv(8, 1536, 5120)
    assert round(b["ms"], 4) == 0.0752 and b["by"] == "bytes"


def test_dd_rmv_batched_short_lanes():
    # Row 2b at (256, 64, 128): 0.0026 ms.
    b = roofline.dd_rmv(256, 64, 128)
    assert round(b["ms"], 4) == 0.0026 and b["by"] == "bytes"


def test_assembly_on_the_m16384_schedule():
    # Row 4b on 8 lanes: 0.0461 ms; row 4 alone: 28.7 MB, 0.0086 ms.
    b8 = roofline.assemble_pairs(8, **M16K)
    b1 = roofline.assemble_pairs(1, **M16K)
    assert round(b8["ms"], 4) == 0.0461 and b8["by"] == "bytes"
    assert round(b1["ms"], 4) == 0.0086 and round(b1["bytes"] / 1e6, 1) == 28.7


def test_tile_kernel_bound():
    # K1 at b = 128 alone: 0.000049 ms; (8, 128, 128) batched: 0.00039 ms.
    assert round(roofline.potrf_tile(1, 128)["ms"], 6) == 0.000049
    assert round(roofline.potrf_tile(8, 128)["ms"], 5) == 0.00039


def test_a_shared_operand_is_read_once():
    one = roofline.dd_mv(1, 1536, 5120)["bytes"]
    shared = roofline.dd_mv(8, 1536, 5120, shared_a=True)["bytes"]
    assert shared - one == 7 * (4 * 5120 + 8 * 1536)


def _run(bounds_ms, device_ms, pattern_name="dd_mv_kernel"):
    kernels = [(f"{pattern_name}(float const*, float const*)", d * 1e-3) for d in device_ms]
    tr = trace.Trace(window_s=1.0, busy_s=sum(device_ms) * 1e-3, kernels=kernels,
                     idle_by_host={}, device_by_name={})
    launches = {"t": [{"ms": b, "by": "bytes"} for b in bounds_ms]}
    return types.SimpleNamespace(trace=tr, launches=launches, log=[],
                                 say=lambda line: None)


def test_a_kernel_at_its_bound_reads_100_and_no_more():
    bounds = [roofline.dd_mv(128, 1472, 5120)["ms"], roofline.dd_mv(1, 1472, 5120)["ms"]]
    run = _run(bounds, bounds)
    assert roofline.traced_share(run, r"\bdd_mv(_short)?_kernel\b", ["t"]) == \
        pytest.approx(100.0, rel=1e-12)
    slower = _run(bounds, [2 * b for b in bounds])
    assert roofline.traced_share(slower, r"\bdd_mv(_short)?_kernel\b", ["t"]) == \
        pytest.approx(50.0)
    assert roofline.share_pct(1.0, 1.0) == 100.0


def test_unpaired_launches_or_no_kernel_read_nothing():
    bounds = [0.01, 0.02]
    assert roofline.traced_share(_run(bounds, [0.05]), r"\bdd_mv_kernel\b", ["t"]) is None
    assert roofline.traced_share(_run([], []), r"\bdd_mv_kernel\b", ["t"]) is None
    assert roofline.share_pct(0.01, 0.0) is None
