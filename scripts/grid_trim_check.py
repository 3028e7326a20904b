"""Where do the eager grid step and the one-graph grid step part ways? The
eager step's shard_batch trims each dp part to its own sequence bucket;
the captured one graph runs every part at the block's width. A (4, 2)
grid of this card (2 layers of the default encoder), four steps on
batches whose parts trim apart and on batches whose parts do not: the
losses and the final parameters and optimizer state of two eager runs
and of the one graph. About a minute on an H100.

    python3 scripts/grid_trim_check.py      # from the root of a checkout
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from mobius_rag_tpu_torch.models import encoder as tenc
    from mobius_rag_tpu_torch.models import train as ttrain
    from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh

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

    def run(batches, mesh, graphs):
        step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh,
                                                          graphs=graphs)
        model = shard(params)
        opt = init(model)
        seen = []
        for q, d in batches:
            model, opt, m = step(model, opt, batch(q), batch(d))
            seen.append(float(m["loss"]))
        return seen, [t.detach().clone() for t in ttrain._held(model, opt)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    mesh = make_train_mesh(4, 2, devices=["cuda:0"] * 8)
    for label, rows in (("parts that trim apart", [{0}, {0}, {3, 17}, {0}]),
                        ("parts that do not", [set(range(0, 32, 8))] * 4)):
        batches = [block(r) for r in rows]
        e1, e2, g = run(batches, mesh, False), run(batches, mesh, False), run(batches, mesh, None)
        diff = max(float((x - y).abs().max()) for x, y in zip(g[1], e1[1]))
        print(f"{label}: eager twice losses {e1[0] == e2[0]} state {same(e1, e2)}; one graph "
              f"losses {g[0] == e1[0]} state {same(g, e1)}; max |diff| {diff:.3e}", flush=True)


if __name__ == "__main__":
    main()
