"""The tile engine's Schur-update tile products per batched-loop iteration:
the program's counter ``normal.schur_products`` (one lane's products a
factorization, the dbound retry's included) over the traced call, over the
loops' iterations in it."""

from lpbench import program_spans, schur

LAUNCHES = program_spans.LAUNCHES


def read(run):
    got = schur.counts(run)
    return None if got is None else program_spans.count_per_iter(run, schur.PRODUCTS)
