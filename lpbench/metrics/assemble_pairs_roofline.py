"""The pair-schedule assembly kernel's share of its roofline
(``csrc/assemble_pairs.cu`` ``assemble_chunks_kernel``, K4): each launch's
bound from the engine's schedule and the lanes over the profiler's device
time, in the traced call.  The schedule counted is what the engine hands
the kernel: its pair weights and its 32-bit columns, runs and chunks."""

from lpbench import roofline

KERNELS = r"\bassemble_chunks_kernel\b"


def _nbytes(t):
    return t.numel() * t.element_size()


def _bound(eng, lanes, n_d, n_boost):
    sched = eng._kernel_schedule
    schedule_bytes = _nbytes(eng.asm_w) + sum(_nbytes(t) for t in sched[:5])
    return roofline.assemble_pairs(lanes, schedule_bytes, eng.n_pairs, n_d, n_boost,
                                   eng.NT + 1, eng.b)


def _batched(args, kwargs):
    eng, d, boost = args[:3]
    return _bound(eng, d.shape[0], d.shape[-1], boost.shape[-1])


def _single(args, kwargs):
    eng, d, boost = args[:3]
    return _bound(eng, 1, d.shape[-1], boost.shape[-1])


LAUNCHES = {"cholesky_is_magic_tpu_torch.sparse.tiled_cuda:assemble_pairs_batched": _batched,
            "cholesky_is_magic_tpu_torch.sparse.tiled_cuda:assemble_pairs": _single}


def read(run):
    return roofline.traced_share(run, KERNELS, LAUNCHES)
