"""The port stands alone: it imports nothing of JAX, ml_dtypes or the JAX
package, and PyYAML and aiohttp only inside the functions that need them
(a YAML file read, the HTTP app) — checked at run time in a fresh
interpreter that drives the exact backend (float32 and int8 rows), the
proj backend under both gatings, host residency with its native re-rank,
the ivf, packed and pq backends (pq under host residency too) and the
cross-encoder stage,
a micro-batcher drain through the pipelined engine and one agent run
(every module of the port is imported on the way), at run time for the
front door's library entry points and for the training path and the eval
harness (a few training steps of both encoders, an eval of the toy bank,
a calibration, the fixture stack), at run time for sharded serving and
the last host modules (a sharded engine over CPU shards with exact and
ANN backends, data-parallel encode, the stage profiler, integrity, the
PDF writer, Drive, the index wire format, the slice merge), at run time
for the graft_entry twin (its forward and its nine-stage dryrun, the grid
trainer included), and
statically over every source file of the port and chip_smoke.py. The
port imports no optax either."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mobius_rag_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "yaml", "ml_dtypes", "mobius_rag_tpu")
# imported only inside a function body, never at module level
LAZY = ("yaml", "aiohttp")

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
# the ivf, packed and pq backends (pq under host residency too), and the
# cross-encoder stage
for kw in (dict(vector_backend="ivf"), dict(vector_backend="packed"),
           dict(vector_backend="pq", pq_m=32),
           dict(vector_dtype="int8", vector_residency="host", vector_backend="pq", pq_m=32,
                ivf_nlist=4, lexical_format="sparse")):
    cfg = dataclasses.replace(get_config(), **kw)
    store = ChunkStore(cfg, device="cpu")
    store.add_chunks(toy_corpus(lex, pad_docs=20))
    engine = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed, device="cpu")
    res = engine.search(QueryRequest(query="timely filing deadline for Sunshine Health"), k=3)
    assert res[0].hits, ("no hits", kw)
from mobius_rag_tpu_torch.models.cross_encoder import CrossEncoderConfig, CrossEncoderModel
engine.cross_encoder = CrossEncoderModel(CrossEncoderConfig.tiny(), device="cpu")
res = engine.search(QueryRequest(query="timely filing deadline for Sunshine Health"), k=3)
assert all("cross_encoder" in h.signals for h in res[0].hits), "no cross-encoder signal"
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


def _imported_roots(path: str, module_level: bool = False) -> set[str]:
    """Top-level packages a source imports: anywhere in it, or (with
    `module_level`) outside every function body."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    nodes = [tree]
    roots = set()
    while nodes:
        node = nodes.pop()
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        nodes.extend(child for child in ast.iter_child_nodes(node)
                     if not (module_level and isinstance(child, funcs)))
    return roots


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & (set(FORBIDDEN) - set(LAZY))
    assert not _imported_roots(path, module_level=True) & (set(FORBIDDEN) | set(LAZY))


_FRONT_DOOR = """
import sys
from mobius_rag_tpu_torch.api.server import AppContext
import mobius_rag_tpu_torch.providers
import mobius_rag_tpu_torch.models.checkpoint
assert AppContext.build
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_front_door_imports_no_jax_aiohttp_or_yaml():
    """AppContext (the library entry point), the provider registry and the
    encoder's checkpoints load without JAX, aiohttp or PyYAML."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _FRONT_DOOR.format(forbidden=set(FORBIDDEN) | {"aiohttp"})],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_NEW_MODULES = """
import importlib, sys
for name in {names!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mobius_rag_tpu"))
print("FORBIDDEN", bad)
"""


def test_front_door_modules_import_nothing_of_the_jax_package():
    """Every module of the front door (ingest, encoder and cross-encoder,
    providers, host stores, the HTTP app and its route modules) and the
    ANN backends' modules (ops.pq, index.ann_io) imported in one fresh
    interpreter, aiohttp included, loads no JAX and nothing of
    mobius_rag_tpu."""
    names = sorted(
        "mobius_rag_tpu_torch." + os.path.relpath(os.path.join(root, f), PKG)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for sub in ("api", "ingest", "models", "eval_harness", "parallel")
        for root, _, files in os.walk(os.path.join(PKG, sub)) for f in files
        if f.endswith(".py")) + [f"mobius_rag_tpu_torch.{m}" for m in (
            "providers", "blobstore", "candidates", "tenancy", "infra", "nightly",
            "ops.pq", "index.ann_io", "index.service", "profiling", "integrity",
            "export_pdf", "drive")]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NEW_MODULES.format(names=names)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_TRAIN_EVAL = """
import sys
from mobius_rag_tpu_torch.eval_harness import (bank, calibrate, derive_priors, fact_checker,
                                               judge, lexical_oracle, matrix, run)
from mobius_rag_tpu_torch.eval_harness.fixture_corpus import build_fixture_stack
from mobius_rag_tpu_torch.models import cross_encoder, data, train
from mobius_rag_tpu_torch.models.encoder import EncoderConfig
agent, engine, store, _, info = build_fixture_stack(device="cpu")
assert info["chunks"] > 50, info
_, hist = train.train_encoder_on_corpus(store, cfg=EncoderConfig.tiny(), steps=2, batch=8,
                                        log_every=1, device="cpu")
assert len(hist) == 2, hist
_, hist = cross_encoder.train_cross_encoder_on_corpus(store, steps=2, batch=4, device="cpu")
out = run.run_eval(agent, "toy")
assert out.aggregates["n"] == 5
cal = calibrate.calibrate(agent, "toy")
lexical_oracle.BM25Oracle(store).search("timely filing")
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_training_and_eval_harness_import_nothing_forbidden():
    """Training both encoders, evaluating and calibrating over the fixture
    stack load no JAX, optax, PyYAML (the banks and the corpus manifest are
    JSON) or JAX-package module."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_EVAL.format(forbidden=set(FORBIDDEN))],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_SHARDED_AND_HOST = """
import sys, types
from mobius_rag_tpu_torch.drive import InMemoryDrive, classify_file
from mobius_rag_tpu_torch.export_pdf import markdown_to_pdf
from mobius_rag_tpu_torch.index.service import record_from_wire, record_to_wire
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.integrity import integrity_report
from mobius_rag_tpu_torch.models.encoder import EncoderConfig, MeshEncoderModel
from mobius_rag_tpu_torch.parallel import ShardedEngine, make_mesh, make_serve_mesh
from mobius_rag_tpu_torch.parallel.slices import merge_slice_results
from mobius_rag_tpu_torch.profiling import profile_engine
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus
lex = sample_lexicon()
store = ChunkStore(device="cpu")
store.add_chunks(toy_corpus(lex, pad_docs=20))
engine = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")
q = QueryRequest(query="timely filing deadline for Sunshine Health")
assert profile_engine(engine, [q], k=3, iters=1)["device_stages_ms"]
for backend in ("exact", "ivf", "packed", "pq", "proj"):
    se = ShardedEngine(store, mesh=make_serve_mesh(2, 2, devices=["cpu"] * 4),
                       vector_backend=backend)
    res = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu", sharded=se).search(q, k=3)
    assert res[0].hits, backend
assert merge_slice_results([res, res], k=3)[0].hits
emb = MeshEncoderModel(make_mesh(2, devices=["cpu"] * 2), EncoderConfig.tiny())(["a b", "c"])
assert emb.shape[0] == 2
assert integrity_report(types.SimpleNamespace(store=store, pipeline=None))["ok"]
assert markdown_to_pdf("# x").startswith(b"%PDF") and classify_file("a.pdf")
rec = store.record(0)
assert record_from_wire(record_to_wire(rec)).chunk_id == rec.chunk_id
assert InMemoryDrive({{"f": [("a.txt", b"x")]}}).list_folder("f")
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_sharded_serving_and_host_wiring_import_nothing_forbidden():
    """Sharded serving over every backend, data-parallel encode, the stage
    profiler and the last host modules load no JAX, PyYAML, aiohttp or
    JAX-package module."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDED_AND_HOST.format(forbidden=set(FORBIDDEN) | {"aiohttp"})],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_GRAFT_ENTRY = """
import sys
from mobius_rag_tpu_torch import graft_entry
fwd, (params, tokens) = graft_entry.entry("cpu")
assert fwd(params, tokens[:2]).shape == (2, 1536)
graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_graft_entry_imports_nothing_forbidden():
    """The graft_entry twin (the encoder's entry forward, and the nine-stage
    dryrun over ["cpu"] * 8: the grid trainer, sharded serving, mesh encode,
    the slice merge) loads no JAX, optax, PyYAML, aiohttp or JAX-package
    module."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _GRAFT_ENTRY.format(forbidden=set(FORBIDDEN) | {"aiohttp"})],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout and "dryrun multi-slice ok" in proc.stdout, proc.stdout
