"""Nightly maintenance orchestrator.

Reference parity (app/nightly_orchestrator.py:1-745 + nightly_infra.py):
a daemon-thread pipeline of ordered steps with per-step live state,
hard serialization invariants (evals never overlap corpus writes), and
a lift computation comparing baseline vs final eval. Cloud-infra
resizing (Cloud SQL tier / Cloud Run scaling) maps to `infra.py`'s
k8s worker-fleet scaling: when no explicit hooks are supplied the
orchestrator calls infra.scale("up"/"freeze"/"down") — a no-op with a
stated reason unless the pod is configured (in-cluster env or
MRAG_K8S_API), and always best-effort like the reference's
(nightly_infra.py:15-17: "a run proceeds on whatever infra is up").

Steps: infra_up → baseline_eval → retag → chunk_sweep → embed_sweep →
freeze(snapshot) → final_eval → lift → infra_down.

Ported from ``mobius_rag_tpu.nightly`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Any, Callable

STEPS = ("infra_up", "baseline_eval", "retag", "chunk_sweep", "embed_sweep",
         "freeze", "final_eval", "lift", "infra_down")


@dataclasses.dataclass
class StepState:
    name: str
    status: str = "pending"  # pending | running | done | failed | skipped
    started_at: float | None = None
    finished_at: float | None = None
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)
    error: str | None = None


class NightlyOrchestrator:
    def __init__(self, ctx, *, bank: str = "toy",
                 infra_up: Callable[[], Any] | None = None,
                 infra_down: Callable[[], Any] | None = None,
                 snapshot_path: str | None = None):
        from mobius_rag_tpu_torch import infra

        self.ctx = ctx  # api.server.AppContext (or anything duck-typed)
        self.bank = bank
        self.infra_up = infra_up or (lambda: {"infra": infra.scale("up")})
        self.infra_down = infra_down or (lambda: {"infra": infra.scale("down")})
        self.snapshot_path = snapshot_path
        self.state: dict[str, StepState] = {}
        self.run_id: str | None = None
        # finished-run ledger (reference GET /admin/nightly/runs)
        self.history: list[dict[str, Any]] = []
        self._stop_requested = False
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # serialization invariant: eval steps and corpus-write steps share
        # this lock with the API's write paths when deployments wire it in
        self.corpus_write_lock = threading.Lock()

    # -- public ------------------------------------------------------------

    def start(self) -> str:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("nightly run already in progress")
            import uuid

            self.run_id = f"nightly-{int(time.time())}-{uuid.uuid4().hex[:6]}"
            self._stop_requested = False
            self.state = {s: StepState(s) for s in STEPS}
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self.run_id

    def status(self) -> dict[str, Any]:
        return {
            "run_id": self.run_id,
            "steps": {s: dataclasses.asdict(st) for s, st in self.state.items()},
            "running": self._thread.is_alive() if self._thread else False,
        }

    def wait(self, timeout_s: float = 600.0) -> None:
        if self._thread:
            self._thread.join(timeout=timeout_s)

    def stop(self) -> bool:
        """Request a graceful stop: steps not yet started are skipped
        (infra_down still runs so infra never stays scaled up). The
        in-flight step finishes — corpus writes are never interrupted
        mid-publish. Returns whether a run was live."""
        live = self._thread is not None and self._thread.is_alive()
        self._stop_requested = True
        return live

    # -- steps -------------------------------------------------------------

    def _step(self, name: str, fn: Callable[[], dict[str, Any] | None]) -> bool:
        st = self.state[name]
        if self._stop_requested and name != "infra_down":
            st.status = "skipped"
            st.detail = {"reason": "stop requested"}
            return False
        st.status = "running"
        st.started_at = time.time()
        try:
            st.detail = fn() or {}
            st.status = "done"
            return True
        except Exception as e:
            st.status = "failed"
            st.error = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=3)}"
            return False
        finally:
            st.finished_at = time.time()

    def _eval(self) -> dict[str, Any]:
        from mobius_rag_tpu_torch.eval_harness.run import run_eval

        out = run_eval(self.ctx.agent, self.bank, db=self.ctx.eval_db)
        return {"run_id": out.run_id, **out.aggregates}

    def _run(self) -> None:
        ok = self._step("infra_up", self.infra_up)
        baseline: dict[str, Any] = {}

        def baseline_eval():
            nonlocal baseline
            baseline = self._eval()
            return baseline

        ok = ok and self._step("baseline_eval", baseline_eval)

        def retag():
            from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

            with self.corpus_write_lock:
                n = 0
                by_doc: dict[str, list] = {}
                for rec in self.ctx.store.records:
                    if rec is not None:
                        by_doc.setdefault(rec.doc_id, []).append(rec)
                for doc_id, recs in by_doc.items():
                    for rec in recs:
                        featurize_chunk(rec, self.ctx.engine.lexicon)
                        n += 1
                    self.ctx.store.publish_document(doc_id, recs)
            return {"retagged": n}

        ok = ok and self._step("retag", retag)

        def chunk_sweep():
            with self.corpus_write_lock:
                n = self.ctx.pipeline.chunking_worker.run_loop(max_jobs=1000)
            return {"jobs": n}

        ok = ok and self._step("chunk_sweep", chunk_sweep)

        def embed_sweep():
            with self.corpus_write_lock:
                n = self.ctx.pipeline.embedding_worker.run_loop(max_jobs=1000)
            return {"jobs": n}

        ok = ok and self._step("embed_sweep", embed_sweep)

        def freeze():
            import os

            from mobius_rag_tpu_torch import infra
            from mobius_rag_tpu_torch.config import get_config

            # idle the writers before the final eval (reference 'freeze'
            # direction, nightly_infra.py:125-127) — best-effort
            infra_note = infra.scale("freeze")
            path = self.snapshot_path or os.path.join(
                get_config().data_dir, f"{self.run_id}-snapshot")
            with self.corpus_write_lock:
                self.ctx.store.snapshot(path)
            return {"path": path, "chunks": self.ctx.store.size,
                    "infra": infra_note}

        ok = ok and self._step("freeze", freeze)

        final: dict[str, Any] = {}

        def final_eval():
            nonlocal final
            final = self._eval()
            return final

        ok = ok and self._step("final_eval", final_eval)

        def lift():
            keys = ("accuracy", "mean_chunk_recall", "answer_rate")
            return {k: round(final.get(k, 0.0) - baseline.get(k, 0.0), 4)
                    for k in keys}

        if ok:
            self._step("lift", lift)
        else:
            self.state["lift"].status = "skipped"
        self._step("infra_down", self.infra_down)
        snap = self.status()
        snap["running"] = False  # final snapshot, taken inside the thread
        snap["stopped"] = self._stop_requested
        self.history.append(snap)
