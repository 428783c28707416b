"""Set-up seconds in the tile engine's build (``engine_for_sparse``: the
host symbolic analysis, the pair schedule and its copy to the card),
timed between two synchronizes in set-up."""

SETUP_SPANS = {"analysis": "cholesky_is_magic_tpu_torch.sparse.tiled:engine_for_sparse"}


def read(run):
    if "analysis" not in run.setup_spans:
        return None
    return run.setup_spans["analysis"][0]
