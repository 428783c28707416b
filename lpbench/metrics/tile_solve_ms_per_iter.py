"""Host ms per batched-loop iteration in the tile engine's blocked
forward and backward substitutions (``TiledCholesky.solve``), each call
timed between two synchronizes in the traced run's span call."""

SPANS = {"tile_solve": "cholesky_is_magic_tpu_torch.sparse.tiled:TiledCholesky.solve"}


def read(run):
    if "tile_solve" not in run.spans or run.span_iterations <= 0:
        return None
    return 1e3 * run.spans["tile_solve"][0] / run.span_iterations
