"""Run the port's `cuda`-marked tests (the kernels, the sparse lexical arm's
kernels at the benchmark's shapes and under the captured and sharded
engines against the plain version, the pipelined engine's
dispatch without a device-to-host wait, the captured search programs
bitwise against the eager ones, the captured encoder and cross-encoder
forwards bitwise against the eager ones, an ingesting, a searching and a
profiling thread on one engine and encoder, the encoder's bf16 against
float32 activations, a captured training step and a (2, 2) grid training
step against their CPU twins, the captured training steps bitwise against
the eager ones on one device and on a (2, 2) grid of this card, the
segment graphs of a grid over several cards forced on this card ((2, 2)
and (4, 1) bitwise against eager, blocks whose dp parts alone would trim
apart run at the block's width bitwise against eager and the one graph, a
(4, 2) step against its CPU twin, a failed capture that leaves nothing
behind; with four cards (2, 2), (4, 1) and (2, 4) grids over cuda:0..3
bitwise against their eager steps, which raise no AccumulateGrad stream
warning), the
capturable AdamW against the CPU's update, a replayed training step that
reads nothing back, the sharded engine against the dense one, its
captured programs bitwise against its eager one on grids of this card
(exact over 4 shards and a [2, 4] grid, sparse postings, ivf, pq under
host residency), the same cases on the route of a grid over several
cards forced on this card (one graph per device and stage) bitwise
against the eager program and the one-graph route, a writer thread
publishing and refreshing while another searches it on either route,
and the data-parallel encoder over this card named 2 and 4 times,
captured bitwise against eager; with four cards the staged route over
cuda:0..3 against the one graph on cuda:0 for each staged case, a writer
thread on it, and the data-parallel encoder over cuda:0..3 bitwise against
eager and against EncoderModel on cuda:0 part by part) on a CUDA card
whose machine has no JAX; the four-card tests skip on fewer cards. Those tests
use only the torch side; their modules import the JAX package for their
CPU tests, so those imports become mocks here and only the `on_card`
tests are collected.

    python3 scripts/card_tests.py [-k EXPR]  # from the root of a checkout

``-k`` narrows the tests further (``-k over_cards`` runs the four-card ones).
"""
import os
import sys
from unittest.mock import MagicMock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOCKED = ["jax", "jax.numpy", "jax.sharding", "mobius_rag_tpu", "mobius_rag_tpu.config",
          "mobius_rag_tpu.index",
          "mobius_rag_tpu.index.ann_io", "mobius_rag_tpu.index.ivf",
          "mobius_rag_tpu.index.store", "mobius_rag_tpu.ingest",
          "mobius_rag_tpu.ingest.featurize", "mobius_rag_tpu.ops", "mobius_rag_tpu.ops.proj",
          "mobius_rag_tpu.ops.pallas_proj", "mobius_rag_tpu.ops.quant", "mobius_rag_tpu.ops.topk",
          "mobius_rag_tpu.query", "mobius_rag_tpu.query.engine", "mobius_rag_tpu.testing",
          "mobius_rag_tpu.models", "mobius_rag_tpu.models.checkpoint",
          "mobius_rag_tpu.models.cross_encoder",
          "mobius_rag_tpu.models.encoder", "mobius_rag_tpu.models.tokenizer",
          "mobius_rag_tpu.models.data", "mobius_rag_tpu.models.train", "mobius_rag_tpu.ops.pq",
          "mobius_rag_tpu.parallel", "mobius_rag_tpu.parallel.mesh",
          "mobius_rag_tpu.parallel.sharded", "optax"]


def main() -> int:
    import pytest

    sys.path.insert(0, ROOT)
    for name in MOCKED:
        sys.modules[name] = MagicMock()
    narrow = f" and ({sys.argv[2]})" if sys.argv[1:2] == ["-k"] else ""
    return pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                        "-k", f"on_card{narrow}", "-rs",
                        *(os.path.join(ROOT, "tests", f"test_torch_{m}.py")
                          for m in ("topk", "lexical", "quant", "proj", "pipelined", "compiled",
                                    "encoder", "cross_encoder", "train", "train_grid",
                                    "sharded"))])


if __name__ == "__main__":
    sys.exit(main())
