"""Host ms per batched-loop iteration in the tile engine's panel loop
(``TiledCholesky.factorize``: the tile factor, TRSM and SYRK per panel),
each call timed between two synchronizes in the traced run's span call."""

SPANS = {"factorize": "cholesky_is_magic_tpu_torch.sparse.tiled:TiledCholesky.factorize"}


def read(run):
    if "factorize" not in run.spans or run.span_iterations <= 0:
        return None
    return 1e3 * run.spans["factorize"][0] / run.span_iterations
