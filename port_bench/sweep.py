"""The knee of an open-loop cell, found once when the cell is defined:

    python3 -m port_bench.sweep --workload <cell> --seed <n> --rates 400,800,1200 [--seconds 6]

builds the cell once, then offers each rate in turn (the mix with its
`rate` replaced) and prints a JSON line a rate: achieved q/s, shed
requests, latency p50 / p95 / p99 from the due time, the p95 of the
window's first and second halves and the mean of its thirds (a queue
that grows shows as later parts slower than earlier ones), the
micro-batcher's fill and the generator's lateness. The knee is the highest rate with no shedding and
no growing queue; the cell's mix then offers a fixed rate below it."""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    from port_bench import run, spec, traffic
    from port_bench import system as sysmod

    ap = argparse.ArgumentParser(description="an open-loop cell's knee")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg_path = spec.config_path(bench, cell["config"])
    cfg = spec.load_json(cfg_path)
    mix = spec.load_json(spec.mix_path(cell["traffic"]))
    run.set_caches(spec.ROOT)
    sysm, _, _, reqs = run.set_up(cfg, mix, os.path.join(os.path.dirname(cfg_path),
                                                         cfg["lexicon"]),
                                  args.seed, "cuda", {})
    for rate in [float(r) for r in args.rates.split(",")]:
        m = dict(mix, rate=rate)
        due, picks = traffic.arrivals(m, args.seed, args.seconds)
        w = sysmod.served_window(sysm, reqs, due, picks, m["warmup_s"], args.seconds, set())
        lat = w["latency_ms"]
        due_w = due[(due >= m["warmup_s"]) & (due < m["warmup_s"] + args.seconds)]
        half = due_w < m["warmup_s"] + args.seconds / 2
        third = (due_w - m["warmup_s"]) * 3 // args.seconds
        print(json.dumps({
            "rate": rate, "attempted": w["attempted"], "failed": w["failed"],
            "shed": w["shed"], "achieved_qps": (w["attempted"] - w["failed"]) / args.seconds,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "p95_first_half_ms": float(np.percentile(lat[half], 95)),
            "p95_second_half_ms": float(np.percentile(lat[~half], 95)),
            "mean_ms_by_third": [float(lat[third == i].mean()) for i in range(3)],
            "batch_fill": 100.0 * w["queries"] / max(w["batches"] * w["max_batch"], 1),
            "late_p95_ms": float(np.percentile(w["late_ms"], 95)),
            "captures": w["captures"]}), flush=True)
    sysm.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
