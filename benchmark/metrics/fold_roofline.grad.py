"""The fold (``k4_table_fold``, the table reduction of the replay's
cotangents) against its bytes bound: each launch reads the 19 cotangents
and the id of every ray-bounce of the chunk's planned prefixes and writes
the (L, 19) table cotangent (``common/roofline.fold_bytes``), over
3.35 TB/s, as a share of its device time in the trace."""
from benchmark.common import profile, roofline


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if ctx["kind"] != "grad" or tr is None or not ctx["items"]:
        return None
    launches = ctx["counters"]["fold_launches"]
    nbytes = roofline.fold_bytes(w["fold_rays_per_chunk"], w["L"]) * launches
    return roofline.share_pct(nbytes, profile.seconds_of(tr["kernels"], "k4_table_fold"))
