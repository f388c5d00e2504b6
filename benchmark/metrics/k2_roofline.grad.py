"""K2 (``k2_replay_bwd``) against its bytes bound: the bytes its launches
in the window need (``common/roofline.k2_bytes``: the (D, 19, B) float32
output, each ray's inputs, every recorded winner id and the table, each
once) over 3.35 TB/s, as a share of its device time in the trace."""
from benchmark.common import profile, roofline


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if ctx["kind"] != "grad" or tr is None or not ctx["items"]:
        return None
    launches = ctx["counters"]["k2_launches"]
    segments = sum(w["segments_per_item"])
    nbytes = roofline.k2_bytes(w["B"], w["D"], 0, w["L"]) * launches + 4 * segments
    return roofline.share_pct(nbytes, profile.seconds_of(tr["kernels"], "k2_replay_bwd"))
