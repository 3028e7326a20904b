"""The whole batch's share of one H100's peak, %: the least time the
batch's work needs (roofline.search_work: the larger of its bytes over
HBM's rate and its operations over their peaks) over the window's wall
time per batch."""
from port_bench import roofline


def read(ctx):
    w = ctx["window"]
    if ctx["trace"] is None or ctx["mix"]["kind"] != "backlog" or not w.get("batches"):
        return None
    least, _ = roofline.least_s(*roofline.search_work(ctx["shape"]))
    return 100.0 * least / (w["window_s"] / w["batches"])
