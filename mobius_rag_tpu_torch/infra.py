"""Auto-infra for the nightly orchestrator.

Reference parity (app/nightly_infra.py:1-132): `scale("up")` at run
start grows the worker fleet so sweeps don't starve, `scale("freeze")`
idles writers before the final eval, `scale("down")` reverts — all
best-effort, never raising to the orchestrator.

The reference's levers are Cloud SQL tiers + Cloud Run instance counts.
On a TPU pod the deploy substrate is Kubernetes (deploy/k8s-tpu.yaml):
the equivalent lever is the Deployment *scale subresource* — pinning
worker replicas, since our workers are self-polling queue claimants
exactly like the reference's (parallelism == replica count; HTTP
autoscaling never fires for them, nightly_infra.py:39-45).

Transport is the k8s REST API over urllib with the in-cluster service
account token — no client library. Gated: `configured()` is False unless
MRAG_K8S_API is set or the pod has in-cluster credentials, and the
orchestrator treats an unconfigured client as a no-op hook.

Ported from ``mobius_rag_tpu.infra`` with the port's imports.
"""
from __future__ import annotations

import json
import os
import ssl
import urllib.request
from typing import Any, Callable

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def api_base() -> str:
    """Explicit override first (tests / kubeconfig proxies), then the
    in-cluster service env k8s injects into every pod."""
    override = _env("MRAG_K8S_API")
    if override:
        return override.rstrip("/")
    host = _env("KUBERNETES_SERVICE_HOST")
    if host:
        port = _env("KUBERNETES_SERVICE_PORT", "443")
        return f"https://{host}:{port}"
    return ""


def _token() -> str:
    tok = _env("MRAG_K8S_TOKEN")
    if tok:
        return tok
    try:
        with open(os.path.join(_SA_DIR, "token")) as f:
            return f.read().strip()
    except OSError:
        return ""


def configured() -> bool:
    return bool(api_base())


def _namespace() -> str:
    ns = _env("MRAG_K8S_NAMESPACE")
    if ns:
        return ns
    try:
        with open(os.path.join(_SA_DIR, "namespace")) as f:
            return f.read().strip()
    except OSError:
        return "default"


def _ssl_context() -> ssl.SSLContext | None:
    ca = os.path.join(_SA_DIR, "ca.crt")
    if os.path.exists(ca):
        return ssl.create_default_context(cafile=ca)
    return None


def _api(method: str, path: str, body: dict | None = None,
         *, content_type: str = "application/json",
         timeout: float = 30.0) -> dict[str, Any]:
    url = api_base() + path
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", content_type)
    tok = _token()
    if tok:
        req.add_header("Authorization", f"Bearer {tok}")
    kwargs: dict[str, Any] = {"timeout": timeout}
    if url.startswith("https://"):
        kwargs["context"] = _ssl_context()
    with urllib.request.urlopen(req, **kwargs) as r:
        raw = r.read().decode()
    return json.loads(raw) if raw else {}


def scale_deployment(name: str, replicas: int) -> dict[str, Any]:
    """PATCH the scale subresource (merge-patch on spec.replicas). The
    subresource — not the Deployment root — is the supported scaling
    surface; patching the root template is the analogue of the
    reference's top-level-``scaling`` silent no-op bug
    (nightly_infra.py:92-98)."""
    ns = _namespace()
    return _api(
        "PATCH",
        f"/apis/apps/v1/namespaces/{ns}/deployments/{name}/scale",
        {"spec": {"replicas": int(replicas)}},
        content_type="application/merge-patch+json",
    )


# Worker deployments managed by the nightly run. Embedding workers are
# the lever (giant-doc embed sweeps bottleneck on them); chunking ships
# at its deploy count and is left alone — reducing it would regress the
# instant-path queue SLA (nightly_infra.py:42-45 makes the same call).
def worker_scale() -> dict[str, int]:
    return {
        _env("MRAG_NIGHTLY_EMBED_DEPLOY", "mrag-embedding-worker"):
            int(_env("MRAG_NIGHTLY_EMBED_WORKERS", "4")),
    }


def worker_floor() -> int:
    # 1 keeps the queue draining after the run reverts
    return int(_env("MRAG_NIGHTLY_WORKER_FLOOR", "1"))


def _scale_workers(targets: dict[str, int]) -> str:
    out = []
    for name, n in targets.items():
        try:
            scale_deployment(name, n)
            out.append(f"{name.rsplit('-', 1)[-1]}={n}")
        except Exception as exc:  # best-effort: a missing RBAC grant
            out.append(f"{name.rsplit('-', 1)[-1]}=err({str(exc)[:40]})")
    return "workers " + ", ".join(out)


def scale(direction: str, stopping: Callable[[], bool] | None = None) -> str:
    """direction: 'up' | 'freeze' | 'down' → human summary. Never raises;
    unconfigured → explicit no-op string so the step detail says why."""
    if not configured():
        return "infra unconfigured (no MRAG_K8S_API / in-cluster env) — no-op"
    del stopping  # k8s scale patches return immediately; nothing to poll
    if direction == "up":
        return _scale_workers(worker_scale())
    if direction in ("freeze", "down"):
        # freeze idles writers before the final eval; down also reverts —
        # identical target here because replicas are our only lever
        return _scale_workers({s: worker_floor() for s in worker_scale()})
    return f"unknown direction: {direction}"
