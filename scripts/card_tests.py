"""Run the port's `cuda`-marked kernel tests on a CUDA card whose machine
has no JAX. Those tests use only the torch side; their modules import the
JAX package for their CPU tests, so those imports become mocks here and
only the `on_card` tests are collected.

    python3 scripts/card_tests.py            # from the root of a checkout
"""
import os
import sys
from unittest.mock import MagicMock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOCKED = ["jax", "jax.numpy", "mobius_rag_tpu", "mobius_rag_tpu.index",
          "mobius_rag_tpu.index.ann_io", "mobius_rag_tpu.index.ivf",
          "mobius_rag_tpu.index.store", "mobius_rag_tpu.ops", "mobius_rag_tpu.ops.proj",
          "mobius_rag_tpu.ops.pallas_proj", "mobius_rag_tpu.ops.quant", "mobius_rag_tpu.ops.topk"]


def main() -> int:
    import pytest

    sys.path.insert(0, ROOT)
    for name in MOCKED:
        sys.modules[name] = MagicMock()
    return pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                        "-k", "on_card", "-rs",
                        *(os.path.join(ROOT, "tests", f"test_torch_{m}.py")
                          for m in ("topk", "quant", "proj"))])


if __name__ == "__main__":
    sys.exit(main())
