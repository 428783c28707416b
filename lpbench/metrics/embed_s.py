"""Set-up seconds in the host ingest of the dense batch (``api.embed_batch``:
each lane padded on the host, stacked, copied to the card once), timed
between two synchronizes in set-up."""

SETUP_SPANS = {"embed": "cholesky_is_magic_tpu_torch.api:embed_batch"}


def read(run):
    if "embed" not in run.setup_spans:
        return None
    return run.setup_spans["embed"][0]
