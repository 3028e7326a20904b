"""Do the three routes of the grid trainer read one width? A (4, 2) grid
of this card (2 layers of the default encoder), four steps on batches
whose dp parts alone would trim to different sequence buckets and on
batches whose parts would not, eager twice, the one graph (the route of a
grid of one card) and the segment graphs (the route of a grid over
several cards, forced on this card): the losses and the final parameters
and optimizer state of each against the first eager run. Every route
trims a block once, then splits it, so all must be bitwise; exits with 1
where one is not. About a minute on an H100.

    python3 scripts/grid_trim_check.py      # from the root of a checkout
"""
import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import chip_smoke as c
    from mobius_rag_tpu_torch.models import encoder as tenc
    from mobius_rag_tpu_torch.models import train as ttrain
    from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh

    smi = c.phase0_device()[1]
    cfg = dataclasses.replace(tenc.EncoderConfig.from_env(), num_layers=2)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)

    def block(long_rows):  # documents of 100 tokens in `long_rows`, else 40
        q = np.zeros((32, cfg.max_seq), np.int32)
        d = np.zeros((32, cfg.max_seq), np.int32)
        for i in range(32):
            nd = 100 if i in long_rows else 40
            q[i, :20] = rng.integers(2, cfg.vocab_size, 20)
            d[i, :nd] = rng.integers(2, cfg.vocab_size, nd)
        return q, d

    def run(batches, mesh, graphs, forced=False):
        with c._forced_stages() if forced else contextlib.nullcontext():
            step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh,
                                                              graphs=graphs)
        model = shard(params)
        opt = init(model)
        seen = []
        for q, d in batches:
            model, opt, m = step(model, opt, batch(q), batch(d))
            seen.append(float(m["loss"]))
        return seen, [t.detach().clone() for t in ttrain._held(model, opt)]

    mesh = make_train_mesh(4, 2, devices=["cuda:0"] * 8)
    failed = []
    for label, rows in (("parts that would trim apart", [{0}, {0}, {3, 17}, {0}]),
                        ("parts that would not", [set(range(0, 32, 8))] * 4)):
        batches = [block(r) for r in rows]
        e1 = run(batches, mesh, False)
        for route, got in (("eager again", run(batches, mesh, False)),
                           ("one graph", run(batches, mesh, None)),
                           ("segmented", run(batches, mesh, None, forced=True))):
            losses = got[0] == e1[0]
            state = all(torch.equal(x, y) for x, y in zip(got[1], e1[1]))
            diff = max(float((x.double() - y.double()).abs().max())
                       for x, y in zip(got[1], e1[1]))
            print(f"{label}: {route} against eager: losses {'equal' if losses else 'differ'}, "
                  f"final state {'bitwise' if state else 'differs'} (max |diff| {diff:.3e}) "
                  f"on {smi}", flush=True)
            if not (losses and state):
                failed.append(f"{label}: {route}")
    print(f"routes parting from eager: {failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
