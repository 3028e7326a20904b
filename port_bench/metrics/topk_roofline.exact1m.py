"""The masked top-k's share of its roofline, %: the least time of one
batch's top-k (roofline.topk_work) over the device time of the kernels
of ops/csrc/topk.cu (topk_tiles and its selection) per batch, from the
trace."""
from port_bench import roofline


def read(ctx):
    t, w, s = ctx["trace"], ctx["window"], ctx["shape"]
    if t is None or s["backend"] != "exact" or not w.get("batches"):
        return None
    dev_s = sum(v for n, v in t["by_name"].items() if n.startswith("topk_"))
    if dev_s <= 0:
        return None
    least, _ = roofline.least_s(*roofline.topk_work(s["batch"], s["rows"], s["dim"], s["m"],
                                                    s["dtype"]))
    return 100.0 * least / (dev_s / w["batches"])
