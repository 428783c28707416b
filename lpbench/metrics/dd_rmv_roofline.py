"""The double-word Aᵀ·y kernels' share of their roofline (``csrc/dd_matvec.cu``
``dd_rmv_kernel``, ``dd_rmv_short_kernel``): each launch's bound from its
shapes over the profiler's device time, in the traced call."""

from lpbench import roofline

KERNELS = r"\bdd_rmv(_short)?_kernel\b"


def _batched(args, kwargs):
    A = args[0]
    return roofline.dd_rmv(A.shape[0], A.shape[1], A.shape[2], shared_a=A.stride(0) == 0)


def _single(args, kwargs):
    A = args[0]
    return roofline.dd_rmv(1, A.shape[0], A.shape[1])


LAUNCHES = {"cholesky_is_magic_tpu_torch.ops.dd_cuda:dd_rmv_batched": _batched,
            "cholesky_is_magic_tpu_torch.ops.dd_cuda:dd_rmv": _single}


def read(run):
    return roofline.traced_share(run, KERNELS, LAUNCHES)
