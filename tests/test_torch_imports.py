"""The port stands alone: it imports nothing of JAX, PyYAML, ml_dtypes or
the JAX package — checked at run time in a fresh interpreter that drives
the exact backend (float32 and int8 rows), the proj backend under both
gatings, host residency with its native re-rank, a micro-batcher drain
through the pipelined engine and one agent run (every module of the port
is imported on the way), and statically over every source file of the
port and chip_smoke.py."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mobius_rag_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "yaml", "ml_dtypes", "mobius_rag_tpu")

SOURCES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(PKG) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]

_DRIVE = """
import sys
import mobius_rag_tpu_torch
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus
lex = sample_lexicon()
store = ChunkStore(device="cpu")
store.add_chunks(toy_corpus(lex, pad_docs=5))
engine = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")
res = engine.search(QueryRequest(query="timely filing deadline for Sunshine Health"), k=3)
assert res[0].hits, "no hits"
# the proj backend under both gatings, over the sparse lexical layout
import dataclasses
from mobius_rag_tpu_torch.config import get_config
for gating in ("dense", "local"):
    cfg = dataclasses.replace(get_config(), vector_backend="proj", lexical_format="sparse",
                              ivf_nlist=4, proj_p=32, gating=gating)
    store = ChunkStore(cfg, device="cpu")
    store.add_chunks(toy_corpus(lex, pad_docs=20))
    engine = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed, device="cpu")
    res = engine.search(QueryRequest(query="timely filing deadline for Sunshine Health"), k=3)
    assert res[0].hits, "no proj hits"
    import os, tempfile
    with tempfile.TemporaryDirectory() as tmp:
        engine.save_ann(os.path.join(tmp, "ann.npz"))
        engine.load_ann(os.path.join(tmp, "ann.npz"))
# int8 rows on the device, and host residency (int8 rows in host RAM, proj
# codes, the funnel and the native exact re-rank)
for kw in (dict(vector_dtype="int8"),
           dict(vector_dtype="int8", vector_residency="host", vector_backend="proj",
                ivf_nlist=4, proj_p=32, lexical_format="sparse")):
    cfg = dataclasses.replace(get_config(), **kw)
    store = ChunkStore(cfg, device="cpu")
    store.add_chunks(toy_corpus(lex, pad_docs=20))
    engine = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed, device="cpu")
    res = engine.search(QueryRequest(query="timely filing deadline for Sunshine Health"), k=3)
    assert res[0].hits, ("no hits", kw)
from mobius_rag_tpu_torch.utils import native
assert native.gather_cos.native_calls or native.get_lib() is None
# the served path: a micro-batcher drain (a queue deeper than one batch goes
# through search_pipelined) and one agent run with its default clients
import asyncio
from mobius_rag_tpu_torch.clients import StaticFactStore
from mobius_rag_tpu_torch.query.agent import AgentRequest, CorpusSearchAgent
from mobius_rag_tpu_torch.query.microbatch import MicroBatcher
store = ChunkStore(device="cpu")
store.add_chunks(toy_corpus(lex, pad_docs=5))
engine = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")
batcher = MicroBatcher(engine, max_batch=2)
async def drain():
    return await asyncio.gather(*(batcher.search_one(QueryRequest(query=f"timely filing {{i}}"), 3)
                                  for i in range(7)))
assert all(r.hits for r in asyncio.run(drain())), "no hits through the batcher"
agent = CorpusSearchAgent(engine, fact_store=StaticFactStore([]))
res = agent.run(AgentRequest(query="What is the timely filing deadline for Sunshine Health?"))
assert res.chunks and not res.refused, res.strategy_chain
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_port_runs_without_forbidden_modules():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVE.format(forbidden=set(FORBIDDEN))],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def _imported_roots(path: str) -> set[str]:
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & set(FORBIDDEN)
