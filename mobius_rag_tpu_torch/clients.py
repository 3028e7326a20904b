"""Pluggable external-service clients (the port of
``mobius_rag_tpu.clients``).

The reference calls out to a chat-LLM proxy (app/services/
llm_manager_client.py), Google/Vertex web search + page fetch
(corpus_search_strategy_d.py:461-600), and a payor fact-store HTTP
service (corpus_search_agent.py:3808-3960). This framework keeps those
as injection points (strategies c/d/s and synthesis take a client) with
deterministic offline stubs as defaults — the same role the reference's
mocked providers play in its tests (SURVEY §4 tier 2) — so the whole
agent runs hermetically on a zero-egress host and picks up real
backends in deployment by swapping the client object.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Protocol, Sequence


class LLMClient(Protocol):
    def generate(self, prompt: str, *, system: str = "", max_tokens: int = 1024,
                 temperature: float = 0.0, stage: str = "") -> str: ...


class WebSearchClient(Protocol):
    def search(self, query: str, *, max_results: int = 5) -> list[dict[str, str]]: ...
    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str: ...


class FactStoreClient(Protocol):
    def lookup(self, query: str, *, payer: str = "", state: str = "") -> dict[str, Any] | None: ...


@dataclasses.dataclass
class OfflineLLMStub:
    """Deterministic extractive stand-in: 'synthesis' returns the top
    passages verbatim; 'answer with citations' quotes the first context
    sentence. Keeps agent control flow real without a network."""

    transcript: list[dict[str, str]] = dataclasses.field(default_factory=list)

    def generate(self, prompt: str, *, system: str = "", max_tokens: int = 1024,
                 temperature: float = 0.0, stage: str = "") -> str:
        self.transcript.append({"stage": stage, "prompt": prompt[:2000]})
        # extract any CONTEXT passages embedded in the prompt and echo the
        # most relevant sentences — deterministic, citation-shaped output
        passages = re.findall(r"\[passage (\d+)\]\n(.*?)(?=\n\[passage |\Z)", prompt, re.S)
        if passages:
            picked = []
            for pid, text in passages[:3]:
                excerpt = text.strip()[:400].rstrip()
                picked.append(f'{excerpt} [citation: passage {pid}]')
            return "\n".join(picked)
        return "UNKNOWN — offline stub has no model; supply an LLMClient."


class OfflineWebStub:
    """Zero-egress web client: returns no results (strategy d degrades to
    'external unavailable', exactly like the reference's DDG fallback
    failing closed). `offline = True` tells strategy c's citation locator
    to report located_unverified instead of attempting fetches."""

    offline = True

    def search(self, query: str, *, max_results: int = 5) -> list[dict[str, str]]:
        return []

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        return ""


class LLMHTTPError(RuntimeError):
    """Unrecoverable LLM-proxy error (llm_manager_client.py:86 parity)."""


class HTTPLLMClient:
    """Concrete JSON-over-HTTP generation adapter — the deployment hook
    for an LLM-manager-style proxy (reference llm_manager_client.py:211:
    all generation goes through one POST endpoint carrying prompt/system/
    stage, with a transient-retry ladder).

    Request:  POST {url} {"prompt", "system", "stage", "max_tokens",
                          "temperature", "model"}
    Response: {"text": "..."} (or {"completion"/"output"/"content"}).
    Retries transient failures (HTTP 5xx/429, socket errors) with
    exponential backoff; 4xx raises immediately."""

    def __init__(self, url: str, *, model: str = "",
                 headers: dict[str, str] | None = None,
                 timeout_s: float = 120.0, max_retries: int = 3,
                 backoff_s: float = 1.0):
        if not url:
            raise ValueError("HTTPLLMClient requires a URL (MRAG_LLM_URL)")
        self.url = url
        self.model = model
        self.headers = headers or {}
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s

    def generate(self, prompt: str, *, system: str = "", max_tokens: int = 1024,
                 temperature: float = 0.0, stage: str = "") -> str:
        import json
        import time
        import urllib.error
        import urllib.request

        payload = json.dumps({
            "prompt": prompt, "system": system, "stage": stage,
            "max_tokens": max_tokens, "temperature": temperature,
            "model": self.model,
        }).encode()
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(
                    self.url, method="POST", data=payload,
                    headers={"Content-Type": "application/json", **self.headers})
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    body = json.loads(resp.read())
                for key in ("text", "completion", "output", "content"):
                    if isinstance(body.get(key), str):
                        return body[key]
                raise LLMHTTPError(f"no text field in response: {list(body)[:8]}")
            except urllib.error.HTTPError as e:
                if e.code < 500 and e.code != 429:
                    raise LLMHTTPError(f"LLM proxy HTTP {e.code}") from e
                last = e
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last = e
            if attempt < self.max_retries:
                time.sleep(self.backoff_s * (2 ** attempt))
        raise LLMHTTPError(f"LLM proxy unreachable after "
                           f"{self.max_retries + 1} attempts: {last}")


def get_llm_client(url: str | None = None, **kw) -> LLMClient:
    """Env-selected generation client.

    ``MRAG_LLM_PROVIDER=openai|vertex`` selects the concrete wire-format
    adapters (providers_external.py); otherwise ``MRAG_LLM_URL`` set →
    the generic JSON proxy adapter; else the offline extractive stub
    (zero-egress default)."""
    import os

    provider = os.getenv("MRAG_LLM_PROVIDER", "").strip().lower()
    if provider in ("openai", "vertex"):
        from mobius_rag_tpu_torch import providers_external as pe

        cls = (pe.OpenAILLMClient if provider == "openai"
               else pe.VertexLLMClient)
        return cls(**kw)
    url = url if url is not None else os.getenv("MRAG_LLM_URL", "")
    if url:
        return HTTPLLMClient(url, model=os.getenv("MRAG_LLM_MODEL", ""), **kw)
    return OfflineLLMStub()


class StaticFactStore:
    """In-memory fact store for tests / air-gapped deployments: exact-ish
    lookup over seeded (pattern → fact) rows (the reference's payor fact
    service pre-route, strategy s)."""

    def __init__(self, rows: Sequence[dict[str, Any]] = ()):
        self.rows = list(rows)

    def lookup(self, query: str, *, payer: str = "", state: str = "") -> dict[str, Any] | None:
        q = query.lower()
        for row in self.rows:
            if payer and row.get("payer") and row["payer"] != payer:
                continue
            pats = row.get("patterns", [])
            if any(p.lower() in q for p in pats):
                return row
        return None
