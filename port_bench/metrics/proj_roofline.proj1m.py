"""The proj scans' share of their roofline, %: the least time of one
batch's probed int8 block dots (roofline.proj_work) over the device time
of the kernels of ops/csrc/proj_scan.cu (proj_group_kernel,
proj_scan_kernel) per batch, from the trace."""
from port_bench import roofline


def read(ctx):
    t, w, s = ctx["trace"], ctx["window"], ctx["shape"]
    if t is None or s["backend"] != "proj" or not w.get("batches"):
        return None
    dev_s = sum(v for n, v in t["by_name"].items() if n.startswith("proj_"))
    if dev_s <= 0:
        return None
    least, _ = roofline.least_s(*roofline.proj_work(s["batch"], s["probe"], s["scan_rows"],
                                                    s["scan_pairs"], s["p"]))
    return 100.0 * least / (dev_s / w["batches"])
