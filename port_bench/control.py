"""The control of the comparison, and the readings its limits are set
from. Not part of the benchmark's own runs.

The control is the reference put in the system's place and computed in
the precision below the configuration's (``reference.py``,
``precision="control"``: int8 rows in place of bf16, TF32-rounded inputs
to the float32 products); its answers go through the same comparison
as the system's, and it has to come out not correct. For the proj
tables' checks the control reads the system's tables against int8 rows,
with TF32 centroids and projection.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 [--seconds 3]

runs each seed's set-up and a short window of the cell in this one
process, and prints one JSON line a seed: the system's numbers (the
lower readings) and the control's (the upper ones), then the largest
system reading and the smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys

from port_bench import check, reference


def as_answer(ans, k: int) -> dict:
    """A reference answer in the form the comparison reads of the
    system's: the hits above the confidence floor, each arm's first k
    live entries, the strict count."""
    return {"hits": [(r, s) for r, s in ans.finals[0] if s >= ans.floor],
            "arms": [[(r, v) for v, r in ans.arms[a][0][0][:k]] for a in range(3)],
            "strict": ans.strict}


def control_numbers(cfg: dict, mix: dict, lexicon, rows, specs, vecs, pool_ids: list[int],
                    rc, tables, ann) -> dict[str, float]:
    """The control's numbers over the requests `pool_ids`, against the
    full-precision reference `rc` (and its checked `tables`). The
    control's proj tables are the system's `ann` read at the control's
    precision: its checks and its scales from int8 rows, its centroids
    and projection in TF32."""
    k = mix["k"]
    eps = cfg["ties"]["vector"]
    out = {}
    tables_c = None
    if ann is not None:
        tables_c = reference.ProjTables(ann, int(cfg["env"]["MRAG_IVF_NPROBE"]),
                                        cfg["ann_choices"], "control")
        out.update(tables_c.verify(rows, cfg["corpus"]["rows"], eps))
    rc_c = reference.RefCorpus(cfg, lexicon, rows, "control")
    empty = {"hits": [], "arms": [[], [], []], "strict": 0}
    progs, answers = [], []
    step = reference.QUERY_BLOCK
    for lo in range(0, len(pool_ids), step):
        ids = pool_ids[lo:lo + step]
        qc = [reference.Query(rc_c, specs[i], vecs[specs[i]["vec"]], k, 0.0) for i in ids]
        ctrl = [as_answer(a, k) for a in
                reference.answer_block(rc_c, qc, [empty] * len(ids), cfg, tables_c, eps)]
        qf = [reference.Query(rc, specs[i], vecs[specs[i]["vec"]], k, 0.0) for i in ids]
        answers += reference.answer_block(rc, qf, ctrl, cfg, tables, eps)
        progs += ctrl
    out.update(check.compare(progs, answers, 0, k))
    return out


def main(argv=None) -> int:
    from port_bench import run, spec

    ap = argparse.ArgumentParser(description="the control's and the system's readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    run.set_caches(spec.ROOT)
    lows: dict[str, float] = {}
    highs: dict[str, float] = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = run.run_cell(bench, cell, seed, args.seconds, False, control=True)
        sys_n = {n: c["value"] for n, c in res["checks"].items()}
        print(json.dumps({"seed": seed, "correct": res["correct"], "system": sys_n,
                          "control": res["control"], "metrics": res["metrics"]}), flush=True)
        for n, v in sys_n.items():
            lows[n] = max(lows.get(n, 0.0), v)
        for n, v in res["control"].items():
            highs[n] = min(highs.get(n, float("inf")), v)
    print(json.dumps({"system_max": lows, "control_min": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
