"""The tile engine's Schur updates in the traced call: their device time,
their tile products, and the least time an H100 could take for them.

The program opens a ``factorize.schur`` span around each panel's Schur
update inside ``TiledCholesky.factorize`` (the SYRK operands' gathers, the
batched products and the ``index_add_``) and adds one lane's products and
TRSM tiles a factorization to the counters ``normal.schur_products`` and
``normal.trsm_tiles``.  A program without them gives nothing: the readers
return None.
"""

from __future__ import annotations

from lpbench import program_spans, roofline

SPAN = "factorize.schur"
PRODUCTS, PANEL_TILES = "normal.schur_products", "normal.trsm_tiles"


def update(lanes: int, b: int, products: int, panel_tiles: int) -> dict:
    """The bound of ``lanes`` lanes' Schur updates of ``products`` (b, b)
    tile products, whose panels hold ``panel_tiles`` tiles in all: 2b³
    operations a product; each panel's tiles read once and each product's
    destination tile read and written once (a panel's products have
    distinct destinations), 4 bytes an element."""
    return roofline.bound(4 * lanes * b * b * (panel_tiles + 2 * products),
                          2 * b**3 * lanes * products)


def busy_s(run) -> float | None:
    """Device seconds of every kernel, copy and fill launched inside a
    ``factorize.schur`` span in the traced call; None where no such span
    opened or the call was not recorded."""
    got = program_spans.traced(run)
    if got is None or got[0].busy_s <= 0.0:
        return None
    spans = program_spans.reduce(*got)
    return spans[SPAN].busy_s if SPAN in spans else None


def counts(run) -> tuple[int, int] | None:
    """(products, panel tiles) of the traced call's recording, or None
    where the program keeps no such counters."""
    got = program_spans.traced(run)
    if got is None or PRODUCTS not in got[1].counts or PANEL_TILES not in got[1].counts:
        return None
    return got[1].counts[PRODUCTS], got[1].counts[PANEL_TILES]
