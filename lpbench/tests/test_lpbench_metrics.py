"""Per-layer readers on hand-made traces: the libraries' time leaves out the
port's own kernels, whatever their names say."""

import types

import pytest

from lpbench.drive import HERE, load
from lpbench.trace import Trace

LIB = load(HERE, "metrics", "library_ms_per_iter")


def _run(kernels, iterations=2):
    tr = Trace(window_s=1.0, busy_s=0.5, kernels=kernels, idle_by_host={},
               device_by_name={})
    return types.SimpleNamespace(trace=tr, traced_iterations=iterations)


def test_the_ports_kernels_are_found_in_its_sources():
    own = LIB.own_kernels()
    assert {"potrf_tile_kernel", "potrf_panel_kernel", "potrf_schur_kernel",
            "assemble_chunks_kernel", "dd_mv_kernel", "dd_mv_short_kernel",
            "dd_rmv_kernel", "dd_rmv_short_kernel"} <= own


@pytest.mark.parametrize("own", ["void potrf_tile_kernel<128>(float const*, float*, int)",
                                 "potrf_panel_kernel(float*, int)",
                                 "void potrf_schur_kernel<Shape64>(float*)",
                                 "void dd_mv_short_kernel<4, 2>(float const*)",
                                 "assemble_chunks_kernel(int const*, float*)"])
def test_a_hand_written_kernel_adds_nothing(own):
    library = [("void potrf_syrk_nc_kernel<float>(int, float*)", 0.004),
               ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", 0.010)]
    base = LIB.read(_run(library))
    assert base == pytest.approx(1e3 * 0.014 / 2)
    assert LIB.read(_run(library + [(own, 0.030)])) == base
    assert LIB.read(_run([(own, 0.030)])) is None


def test_the_library_kernels_are_counted():
    names = ["volta_sgemm_128x64_nn", "void gemv2T_kernel_val<int, int, float>(x)",
             "void trsm_left_kernel<float>(x)", "potrf_alg2_cta_upper_kernel", "nvjet_tst_64x8"]
    got = LIB.read(_run([(n, 0.001) for n in names] + [("elementwise_kernel", 1.0)],
                        iterations=1))
    assert got == pytest.approx(5.0)
