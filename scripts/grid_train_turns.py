"""Phases 9a and 12a of chip_smoke.py alone: the fixture stack and its
distractors, phase 9's ICT pairs, the full-width encoder's training turns
on one card (9a), then over the (4, 2) and (2, 4) grids of this card,
captured as one graph and, forced, as the segment graphs of a grid over
several cards (12a). About 3.5 minutes on an H100.

    python3 scripts/grid_train_turns.py      # from the root of a checkout
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import chip_smoke as c
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.eval_harness.fixture_corpus import (build_fixture_stack,
                                                                  distractor_corpus)
    from mobius_rag_tpu_torch.models.data import mine_ict_pairs
    from mobius_rag_tpu_torch.models.encoder import EncoderConfig

    t0 = time.perf_counter()
    _, smi = c.phase0_device()
    _, engine, store, _, _ = build_fixture_stack(device="cuda")
    store.add_chunks(distractor_corpus(c.N_DISTRACTORS, engine.lexicon, get_config()))
    pairs = mine_ict_pairs(store, seed=0,
                           max_pairs=2 * c.TRAIN_BATCH * (c.TRAIN_WARMUP + c.TRAIN_TIMED + 2))
    cfg = EncoderConfig.from_env()
    a = c.phase9a_encoder_train(smi, store, pairs, cfg, "cuda")
    del engine, store
    t1 = time.perf_counter()
    c.phase12a_grid_train(smi, pairs, cfg, a["loss_step1"], "cuda")
    c.log(f"phase 12a {time.perf_counter() - t1:.1f} s; all {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
