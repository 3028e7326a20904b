"""mobius_rag_tpu_torch: the PyTorch and CUDA port of mobius_rag_tpu for
an NVIDIA H100.

It keeps the JAX package's module names, so each module's counterpart is
easy to find, and imports nothing from it (nor jax or ml_dtypes; yaml and
aiohttp only inside the functions that read YAML or build the HTTP app).
The JAX package is the reference that tests/test_torch_*.py hold it to.

Ported so far: the strategy-a hybrid query path on a device-resident
store of float32/bfloat16/int8 vectors or under host residency, dense or
sparse lexical layout, with the exact vector backend or an ANN backend
(``index.ivf``: ivf and packed; ``ops.pq``: pq, also under host
residency; ``ops.proj``: proj under dense or candidate-local gating,
``query.gating``; tables saved and loaded by ``index.ann_io``) and an
optional cross-encoder rescoring stage (``models.cross_encoder``); and
the served path on top:
the overlapped ``SearchEngine.search_pipelined``, the micro-batcher
(``query.microbatch``), the telemetry store (``observability``) and the
retrieval agent (``query.agent`` with ``query.classify``, ``query.gate``,
``query.router``, ``query.strategies``, ``clients``,
``providers_external`` and ``curator``); and the front door: the HTTP
app (``api.server``: ``AppContext``, ``build_app``, ``main``; ``api.ops``,
``api.extended``), the upload → chunk → embed → publish ingest path
(``ingest``), the provider registries (``providers``) with the on-card
transformer encoder as the default embedder (``models``), and the host
stores the context builds. Every TPU kernel has a
hand-written Hopper counterpart: the masked cosine top-k
(``ops/csrc/topk.cu``) and the raw and gated probed block scans
(``ops/csrc/proj_scan.cu``). Every device is explicit: ``ChunkStore``
and ``SearchEngine`` take ``device`` (default ``"cuda"``).

Float32 matrix products run in full float32 on the card: TF32 is
switched off here, for the whole process, because the tests and the
on-card comparisons hold float32 results to 1e-5.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
