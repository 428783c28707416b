"""The tile engine's Schur updates' share of their roofline: the bound of
the traced call's counted products (``normal.schur_products`` and the
panels' tiles ``normal.trsm_tiles``, one lane's, times the lanes, at the
traffic's block; :func:`lpbench.schur.update`) over the device time of the
``factorize.schur`` spans."""

from lpbench import program_spans, roofline, schur

LAUNCHES = program_spans.LAUNCHES


def read(run):
    got, s = schur.counts(run), schur.busy_s(run)
    b = run.traffic.get("block")
    if got is None or not s or b is None:
        return None
    bound = schur.update(run.lanes, b, *got)
    share = roofline.share_pct(bound["ms"], 1e3 * s)
    run.say(f"[roofline] Schur updates: {got[0]} products, {got[1]} panel tiles a lane,"
            f" {run.lanes} lanes, b {b}: device {1e3 * s:.4f} ms, bound {bound['ms']:.4f} ms"
            f" ({bound['by']}; {roofline.PEAK_BYTES_PER_S / 1e12:.2f} TB/s,"
            f" {roofline.PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32 at"
            f" {roofline.PEAK_POWER_W:.0f} W), {share:.2f}%")
    return share
