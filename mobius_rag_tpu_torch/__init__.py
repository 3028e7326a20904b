"""mobius_rag_tpu_torch: the PyTorch and CUDA port of mobius_rag_tpu for
an NVIDIA H100.

It keeps the JAX package's module names, so each module's counterpart is
easy to find, and imports nothing from it (nor jax, ml_dtypes or yaml).
The JAX package is the reference that tests/test_torch_*.py hold it to.

Ported so far: the strategy-a hybrid query path on a device-resident
store of float32/bfloat16 vectors, dense or sparse lexical layout, with
the exact vector backend or the proj ANN backend (``ops.proj``,
``index.ivf``, ``index.ann_io``) under dense or candidate-local gating
(``query.gating``). Every TPU kernel has a hand-written Hopper
counterpart: the masked cosine top-k (``ops/csrc/topk.cu``) and the raw
and gated probed block scans (``ops/csrc/proj_scan.cu``). Every device
is explicit: ``ChunkStore`` and ``SearchEngine`` take ``device``
(default ``"cuda"``).

Float32 matrix products run in full float32 on the card: TF32 is
switched off here, for the whole process, because the tests and the
on-card comparisons hold float32 results to 1e-5.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
