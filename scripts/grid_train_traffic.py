"""The training grid's captured routes on the trainer's own traffic: the ICT
pairs and batches that ``train_encoder_on_corpus`` draws for STEPS steps
(phase 9's fixture stack and distractors, seed 0, batch 32), at the
default encoder's full width, from the same parameters, over each grid of
this card named dp x tp times:

- eager (``graphs=False``);
- segmented: the route of a grid over several cards, forced on this card
  (``chip_smoke._forced_stages``): a key is the block's (B, Lq, Ld), a
  row's tower is captured once a width, a tail once a key;
- one graph: the route of a grid of one card, one graph a key.

Every route trims a block once, then splits it over dp. Prints, per grid
and route: the keys seen and the steps at which each new one came, the
rows' captures, captures and their seconds, the pool's GiB, the whole
run's seconds and ms a step with every capture and eager first step
included, ms a step over the steps after the last new key, and the
largest difference of the final parameters and optimizer state from the
eager run's. Asserts each captured run's per-step losses and final state
bitwise the eager run's, and the segmented route's keys the one graph's.
About 10 minutes on an H100 at 300 steps.

    python3 scripts/grid_train_traffic.py [--steps 300] [--grids 4x2,2x4]

``--device cpu`` rehearses it with captures of graphs=True (set a stand-in
capture, ``models.train.CapturedPrograms``, and a tiny encoder through the
``MRAG_ENCODER_*`` variables first).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(name: str, trainer, params, blocks: list, log) -> dict:
    """`blocks` through `trainer` from `params`: per-step losses and
    seconds, the final state (on the card), the step."""
    from mobius_rag_tpu_torch.models.train import _held

    step, shard, batch, init = trainer
    model = shard(params)
    opt = init(model)
    if next(iter(opt.state.values()))["step"].device.type == "cuda":
        torch.cuda.synchronize()
    losses, secs = [], []
    t0 = time.perf_counter()
    for q, d in blocks:
        ts = time.perf_counter()
        model, opt, m = step(model, opt, batch(q), batch(d))
        losses.append(float(m["loss"]))  # waits for the step
        secs.append(time.perf_counter() - ts)
    total = time.perf_counter() - t0
    state = [t.detach().clone() for t in _held(model, opt)]
    log(f"{name}: {len(blocks)} steps in {total:.3f} s ({1e3 * total / len(blocks):.3f} ms a "
        f"step, every capture and eager first step included)")
    return {"losses": losses, "secs": secs, "total": total, "state": state, "step": step}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--grids", default="4x2,2x4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import chip_smoke as c
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.eval_harness.fixture_corpus import (build_fixture_stack,
                                                                  distractor_corpus)
    from mobius_rag_tpu_torch.models.data import mine_ict_pairs, pretokenized_batches
    from mobius_rag_tpu_torch.models.encoder import EncoderConfig, init_params, seq_bucket
    from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer
    from mobius_rag_tpu_torch.models.train import TrainConfig, make_train_step
    from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh

    log = c.log
    t_all = time.perf_counter()
    dev = args.device
    smi = c.phase0_device()[1] if dev == "cuda" else dev
    graphs = None if dev == "cuda" else True
    cfg = EncoderConfig.from_env()
    _, engine, store, _, _ = build_fixture_stack(device=dev)
    store.add_chunks(distractor_corpus(c.N_DISTRACTORS, engine.lexicon, get_config()))
    pairs = mine_ict_pairs(store, max_pairs=args.steps * c.TRAIN_BATCH * 2, seed=0)
    del engine, store
    tok = HashTokenizer(cfg.vocab_size, cfg.max_seq)
    blocks = list(pretokenized_batches(pairs, tok, c.TRAIN_BATCH, steps=args.steps, seed=0))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    log(f"{len(pairs)} pairs, {len(blocks)} batches of {c.TRAIN_BATCH}; encoder "
        f"{cfg.num_layers} x {cfg.model_dim}, {cfg.dtype} activations; on {smi}")
    for grid in args.grids.split(","):
        dp, tp = (int(x) for x in grid.split("x"))
        mesh = make_train_mesh(dp, tp, devices=[dev] * (dp * tp))
        name = f"grid ({dp}, {tp})"
        eager = run(f"{name} eager", make_train_step(cfg, TrainConfig(), mesh, graphs=False),
                    params, blocks, log)
        with c._forced_stages():
            seg_trainer = make_train_step(cfg, TrainConfig(), mesh, graphs=graphs)
        routes = {"segmented": seg_trainer,
                  "one graph": make_train_step(cfg, TrainConfig(), mesh, graphs=graphs)}
        seen = {}
        for route, trainer in routes.items():
            step = trainer[0]
            keys, first = set(), []
            for s, (q, d) in enumerate(blocks):
                k = (len(q), seq_bucket(q).shape[1], seq_bucket(d).shape[1])
                if route == "segmented" and step.key(q, d) != ("train", dp, tp, *k):
                    raise AssertionError(f"{name}: the segmented key {step.key(q, d)} is not "
                                         f"the block's {k}")
                if k not in keys:
                    keys.add(k)
                    first.append(s)
            got = run(f"{name} {route}", trainer, params, blocks, log)
            programs = step.programs
            # the keys each route captured, as (B, Lq, Ld)
            seen[route] = ({k[3:] for k in step._keys} if route == "segmented" else
                           {(lay[0][1][0], lay[0][1][1], lay[1][1][1])
                            for _, lay in programs.graphs})
            pool = programs.pool_bytes() / 2 ** 30
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(got["state"], eager["state"]))
            after = got["secs"][first[-1] + 1:] or [float("nan")]
            eager_after = eager["secs"][first[-1] + 1:] or [float("nan")]
            rows = f", rows' towers captured {len(step._rows)}" if route == "segmented" else ""
            log(f"{name} {route}: {len(keys)} keys, new at steps {first}{rows}; "
                f"{programs.captures} captures in {sum(programs.capture_ms) / 1e3:.3f} s; "
                f"pool {pool:.3f} GiB; ms a step {1e3 * got['total'] / len(blocks):.3f} "
                f"against eager's {1e3 * eager['total'] / len(blocks):.3f} (after the last new "
                f"key: {1e3 * np.mean(after):.3f} against {1e3 * np.mean(eager_after):.3f}); "
                f"final state's largest |difference| from eager's {diff:.3e}; losses "
                f"{'equal' if got['losses'] == eager['losses'] else 'differ'}; on {smi}")
            if diff or got["losses"] != eager["losses"]:
                raise AssertionError(f"{name}: the {route} run is not bitwise eager's")
            programs.clear()
            del got, step, programs
            if dev == "cuda":
                c._empty_cache()
        if seen["segmented"] != seen["one graph"]:
            raise AssertionError(f"{name}: the routes captured different keys: {seen}")
        del eager, routes, seg_trainer
    log(f"all {time.perf_counter() - t_all:.1f} s")


if __name__ == "__main__":
    main()
