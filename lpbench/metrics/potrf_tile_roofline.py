"""The tile factor + inverse kernel's share of its roofline (``csrc/potrf.cu``
``potrf_tile_kernel``, K1): each launch's bound from its tiles over the
profiler's device time, in the traced call."""

from lpbench import roofline

KERNELS = r"\bpotrf_tile_kernel\b"


def _batched(args, kwargs):
    T = args[0]
    return roofline.potrf_tile(T.shape[0], T.shape[-1])


def _single(args, kwargs):
    return roofline.potrf_tile(1, args[0].shape[-1])


LAUNCHES = {"cholesky_is_magic_tpu_torch.ops.chol_cuda:potrf_tile_batched": _batched,
            "cholesky_is_magic_tpu_torch.ops.chol_cuda:potrf_tile": _single,
            "cholesky_is_magic_tpu_torch.ops.chol_cuda:potrf_tile_": _single}


def read(run):
    return roofline.traced_share(run, KERNELS, LAUNCHES)
