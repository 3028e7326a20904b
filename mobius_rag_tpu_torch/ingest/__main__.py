"""Worker process entry points (the port of ``mobius_rag_tpu.ingest``'s
``__main__``; the reference's ``python -m app.worker`` and ``python -m
app.embedding_worker``):

    python -m mobius_rag_tpu_torch.ingest --kind chunking
    python -m mobius_rag_tpu_torch.ingest --kind embedding [--snapshot DIR]
        [--index-url http://host:8000] [--once] [--health-port N] [--device cpu]

Workers share the sqlite job queue across processes. The embedding worker
embeds on ``--device`` (default ``cuda``) and publishes either into the
serving process's live index over RPC (``--index-url``,
``index.service.RemoteIndexClient``) or into the index snapshot, which it
loads first (if any) and writes again after each drained batch, for the
serving process to reload.
"""
from __future__ import annotations

import argparse
import os

from mobius_rag_tpu_torch.blobstore import get_document_store
from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest import shutdown
from mobius_rag_tpu_torch.ingest.queue import JobQueue
from mobius_rag_tpu_torch.ingest.worker import ChunkingWorker, EmbeddingWorker
from mobius_rag_tpu_torch.observability import setup_logging
from mobius_rag_tpu_torch.providers import get_embedding_provider
from mobius_rag_tpu_torch.query.lexicon import Lexicon


def _start_health_server(port: int, stale_after_s: float = 120.0):
    """Liveness endpoint: /health answers 503 once the worker's tick is
    older than `stale_after_s`, so a supervisor replaces the instance.
    Returns (tick, server); the worker loop calls tick()."""
    import json
    import threading
    import time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    last_tick = {"t": time.time()}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            age = time.time() - last_tick["t"]
            ok = age < stale_after_s
            body = json.dumps({"status": "ok" if ok else "stale",
                               "tick_age_s": round(age, 1)}).encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # no access log
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def tick():
        last_tick["t"] = time.time()

    return tick, server


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["chunking", "embedding"], required=True)
    ap.add_argument("--queue", default=None, help="job queue sqlite path")
    ap.add_argument("--snapshot", default=None, help="index snapshot dir")
    ap.add_argument("--index-url", default=os.getenv("MRAG_INDEX_URL", ""),
                    help="serving process base URL: publish into its live index "
                         "over RPC instead of through the snapshot")
    ap.add_argument("--provider", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder and the snapshot's index")
    ap.add_argument("--once", action="store_true", help="drain and exit")
    ap.add_argument("--health-port", type=int, default=0,
                    help="liveness endpoint port (503 when the tick is >120 s old)")
    args = ap.parse_args(argv)

    log = setup_logging(f"mrag-{args.kind}-worker")
    shutdown.install_handlers()
    queue = JobQueue(args.queue)
    worker_id = f"{args.kind}-{os.getpid()}"
    # the lexicon the server expands queries with, or the tags drift
    lexicon = Lexicon.load(get_config().lexicon_path)
    local_tick = lambda: None  # noqa: E731
    if args.health_port:
        local_tick, _ = _start_health_server(args.health_port)
        log.info("health endpoint on :%d", args.health_port)

    def tick():
        # both liveness surfaces: this process's /health and the shared
        # queue database (the API's /health/deep watches every worker)
        local_tick()
        queue.worker_tick(worker_id, args.kind)

    tick()

    import atexit

    # a clean exit deregisters (a stopped worker must not read as stale);
    # a crash or a freeze leaves the tick to go stale
    atexit.register(queue.deregister_worker, worker_id)

    if args.kind == "chunking":
        # the durable blob store: this process sees what the API uploaded
        worker = ChunkingWorker(queue, get_document_store(), lexicon)
        log.info("chunking worker up")
        n = 0
        while not shutdown.is_shutting_down():
            n += worker.run_loop(max_jobs=100)
            tick()
            if args.once or shutdown.sleep_or_shutdown(1.0):
                break
        log.info("chunking worker done, jobs=%d", n)
        return

    embed = get_embedding_provider(args.provider, device=args.device)
    if args.index_url:
        from mobius_rag_tpu_torch.index.service import RemoteIndexClient

        store = RemoteIndexClient(args.index_url, admin_key=os.getenv("MRAG_ADMIN_KEY", ""))
        worker = EmbeddingWorker(queue, store, lexicon, embed.embed)
        log.info("embedding worker up (remote index %s)", args.index_url)
        while not shutdown.is_shutting_down():
            worker.run_loop(max_jobs=100)
            tick()
            if args.once or shutdown.sleep_or_shutdown(1.0):
                break
        return

    snap = args.snapshot or os.path.join(get_config().data_dir, "snapshot")
    store = (ChunkStore.restore(snap, device=args.device)
             if os.path.exists(os.path.join(snap, "store.json"))
             else ChunkStore(device=args.device))
    worker = EmbeddingWorker(queue, store, lexicon, embed.embed)
    log.info("embedding worker up (index %d chunks)", store.size)
    while not shutdown.is_shutting_down():
        n = worker.run_loop(max_jobs=100)
        tick()
        if n:
            store.snapshot(snap)
            log.info("snapshotted after %d jobs (index %d chunks)", n, store.size)
        if args.once or shutdown.sleep_or_shutdown(1.0):
            break


if __name__ == "__main__":
    main()
