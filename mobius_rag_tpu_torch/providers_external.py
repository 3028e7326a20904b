"""Concrete external provider adapters at the WIRE level (no SDKs) (the port of
``mobius_rag_tpu.providers_external``).

Reference parity (§2.2): app/services/embedding_provider.py:24-149
implements OpenAI (batch 100) and Vertex ``gemini-embedding-001``
(batch 1, 1536-dim pinned) through their vendor SDKs;
app/services/llm_provider.py:38-202 + llm_provider_openai.py do the
same for generation. This framework speaks the same HTTP wire formats
over urllib so a deployment can point at the real endpoints — or at
any gateway speaking the format — without adding dependencies, and the
adapters stay contract-testable offline against a local fake server
(tests/test_providers_external.py).

The ON-CHIP encoder remains the default embedding provider: these
adapters exist for deployments that must match an external embedding
space (e.g. a corpus already embedded by gemini-embedding-001).

Selection:
- ``MRAG_EMBED_PROVIDER=openai|vertex`` (registered in providers.py).
- ``MRAG_LLM_PROVIDER=openai|vertex`` (or MRAG_LLM_URL for the generic
  proxy adapter) via clients.get_llm_client.

Env:
- OpenAI: MRAG_OPENAI_BASE_URL (default https://api.openai.com),
  MRAG_OPENAI_API_KEY, MRAG_OPENAI_EMBED_MODEL, MRAG_OPENAI_MODEL.
- Vertex: MRAG_VERTEX_BASE_URL (default
  https://{location}-aiplatform.googleapis.com), MRAG_VERTEX_PROJECT,
  MRAG_VERTEX_LOCATION, MRAG_VERTEX_TOKEN (a bearer, e.g. from
  ``gcloud auth print-access-token`` or the metadata server),
  MRAG_VERTEX_EMBED_MODEL, MRAG_VERTEX_MODEL.
"""
from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request

import numpy as np

from mobius_rag_tpu_torch.clients import LLMHTTPError
from mobius_rag_tpu_torch.config import get_config


def _post_json(url: str, payload: dict, headers: dict[str, str], *,
               timeout_s: float, max_retries: int = 3,
               backoff_s: float = 1.0) -> dict:
    """POST JSON with the shared transient-retry ladder (HTTP 5xx/429 and
    socket errors retry with exponential backoff; other 4xx raise —
    reference fact_checker.py:53-59 ladder shape)."""
    data = json.dumps(payload).encode()
    last: Exception | None = None
    for attempt in range(max_retries + 1):
        try:
            req = urllib.request.Request(
                url, method="POST", data=data,
                headers={"Content-Type": "application/json", **headers})
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code < 500 and e.code != 429:
                raise LLMHTTPError(f"HTTP {e.code} from {url}") from e
            last = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = e
        if attempt < max_retries:
            time.sleep(backoff_s * (2 ** attempt))
    raise LLMHTTPError(f"{url} unreachable after {max_retries + 1} "
                       f"attempts: {last}")


# ---------------------------------------------------------------------------
# OpenAI wire format
# ---------------------------------------------------------------------------


class OpenAIEmbeddingProvider:
    """``POST {base}/v1/embeddings`` — {"model", "input": [texts]} →
    {"data": [{"index", "embedding"}]}. Batch 100, the reference's
    OpenAI provider contract (embedding_provider.py:33-68)."""

    def __init__(self, *, base_url: str | None = None,
                 api_key: str | None = None, model: str | None = None,
                 dim: int | None = None, batch_size: int = 100,
                 timeout_s: float = 60.0):
        self.base_url = (base_url or os.getenv(
            "MRAG_OPENAI_BASE_URL", "https://api.openai.com")).rstrip("/")
        self.api_key = api_key if api_key is not None else os.getenv(
            "MRAG_OPENAI_API_KEY", "")
        if not self.api_key:
            raise ValueError("OpenAIEmbeddingProvider requires "
                             "MRAG_OPENAI_API_KEY")
        self.model = model or os.getenv("MRAG_OPENAI_EMBED_MODEL",
                                        "text-embedding-3-small")
        self.name = "openai"
        self.dim = dim or get_config().embed_dim
        self.batch_size = batch_size
        self.timeout_s = timeout_s

    def embed(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for off in range(0, len(texts), self.batch_size):
            batch = texts[off:off + self.batch_size]
            body = _post_json(
                f"{self.base_url}/v1/embeddings",
                {"model": self.model, "input": batch,
                 "dimensions": self.dim},
                {"Authorization": f"Bearer {self.api_key}"},
                timeout_s=self.timeout_s)
            for row in body["data"]:
                out[off + int(row["index"])] = np.asarray(
                    row["embedding"], np.float32)
        return out

    __call__ = embed


class OpenAILLMClient:
    """``POST {base}/v1/chat/completions`` → choices[0].message.content
    (llm_provider_openai.py's wire contract)."""

    def __init__(self, *, base_url: str | None = None,
                 api_key: str | None = None, model: str | None = None,
                 timeout_s: float = 120.0):
        self.base_url = (base_url or os.getenv(
            "MRAG_OPENAI_BASE_URL", "https://api.openai.com")).rstrip("/")
        self.api_key = api_key if api_key is not None else os.getenv(
            "MRAG_OPENAI_API_KEY", "")
        if not self.api_key:
            raise ValueError("OpenAILLMClient requires MRAG_OPENAI_API_KEY")
        self.model = model or os.getenv("MRAG_OPENAI_MODEL", "gpt-4o-mini")
        self.timeout_s = timeout_s

    def generate(self, prompt: str, *, system: str = "",
                 max_tokens: int = 1024, temperature: float = 0.0,
                 stage: str = "") -> str:
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        body = _post_json(
            f"{self.base_url}/v1/chat/completions",
            {"model": self.model, "messages": messages,
             "max_tokens": max_tokens, "temperature": temperature,
             # stage rides as vendor-neutral metadata (the reference's
             # llm-manager carries it for bandit routing + tracing)
             "metadata": {"stage": stage} if stage else {}},
            {"Authorization": f"Bearer {self.api_key}"},
            timeout_s=self.timeout_s)
        try:
            return body["choices"][0]["message"]["content"]
        except (KeyError, IndexError, TypeError) as e:
            raise LLMHTTPError(
                f"malformed chat.completions response: {list(body)[:8]}"
            ) from e


# ---------------------------------------------------------------------------
# Vertex wire format
# ---------------------------------------------------------------------------


def _vertex_env(base_url, project, location, token):
    location = location or os.getenv("MRAG_VERTEX_LOCATION", "us-central1")
    base = (base_url or os.getenv(
        "MRAG_VERTEX_BASE_URL",
        f"https://{location}-aiplatform.googleapis.com")).rstrip("/")
    project = project or os.getenv("MRAG_VERTEX_PROJECT", "")
    token = token if token is not None else os.getenv("MRAG_VERTEX_TOKEN", "")
    if not project or not token:
        raise ValueError("Vertex adapters require MRAG_VERTEX_PROJECT and "
                         "MRAG_VERTEX_TOKEN")
    return base, project, location, token


class VertexEmbeddingProvider:
    """``POST {base}/v1/projects/{p}/locations/{l}/publishers/google/
    models/{model}:predict`` — one instance per request by default,
    matching the real ``gemini-embedding-001`` limit the reference pins
    (embedding_provider.py:89: "supports ONE input per request"); a
    gateway without that limit can raise ``batch_size``."""

    def __init__(self, *, base_url: str | None = None,
                 project: str | None = None, location: str | None = None,
                 token: str | None = None, model: str | None = None,
                 dim: int | None = None, batch_size: int = 1,
                 task_type: str = "RETRIEVAL_DOCUMENT",
                 timeout_s: float = 60.0):
        self.base_url, self.project, self.location, self.token = _vertex_env(
            base_url, project, location, token)
        self.model = model or os.getenv("MRAG_VERTEX_EMBED_MODEL",
                                        "gemini-embedding-001")
        self.name = "vertex"
        self.dim = dim or get_config().embed_dim
        self.batch_size = batch_size
        self.task_type = task_type
        self.timeout_s = timeout_s

    @property
    def _url(self) -> str:
        return (f"{self.base_url}/v1/projects/{self.project}/locations/"
                f"{self.location}/publishers/google/models/"
                f"{self.model}:predict")

    def embed(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for off in range(0, len(texts), self.batch_size):
            batch = texts[off:off + self.batch_size]
            body = _post_json(
                self._url,
                {"instances": [{"content": t, "task_type": self.task_type}
                               for t in batch],
                 "parameters": {"outputDimensionality": self.dim}},
                {"Authorization": f"Bearer {self.token}"},
                timeout_s=self.timeout_s)
            for i, pred in enumerate(body["predictions"]):
                out[off + i] = np.asarray(
                    pred["embeddings"]["values"], np.float32)
        return out

    __call__ = embed


class VertexLLMClient:
    """``POST …/models/{model}:generateContent`` →
    candidates[0].content.parts[*].text (llm_provider.py:38-202's
    non-streaming contract)."""

    def __init__(self, *, base_url: str | None = None,
                 project: str | None = None, location: str | None = None,
                 token: str | None = None, model: str | None = None,
                 timeout_s: float = 120.0):
        self.base_url, self.project, self.location, self.token = _vertex_env(
            base_url, project, location, token)
        self.model = model or os.getenv("MRAG_VERTEX_MODEL",
                                        "gemini-2.0-flash")
        self.timeout_s = timeout_s

    def generate(self, prompt: str, *, system: str = "",
                 max_tokens: int = 1024, temperature: float = 0.0,
                 stage: str = "") -> str:
        url = (f"{self.base_url}/v1/projects/{self.project}/locations/"
               f"{self.location}/publishers/google/models/"
               f"{self.model}:generateContent")
        payload: dict = {
            "contents": [{"role": "user", "parts": [{"text": prompt}]}],
            "generationConfig": {"maxOutputTokens": max_tokens,
                                 "temperature": temperature},
        }
        if system:
            payload["systemInstruction"] = {"parts": [{"text": system}]}
        if stage:
            payload["labels"] = {"stage": stage}
        body = _post_json(url, payload,
                          {"Authorization": f"Bearer {self.token}"},
                          timeout_s=self.timeout_s)
        try:
            parts = body["candidates"][0]["content"]["parts"]
            return "".join(p.get("text", "") for p in parts)
        except (KeyError, IndexError, TypeError) as e:
            raise LLMHTTPError(
                f"malformed generateContent response: {list(body)[:8]}"
            ) from e


# ---------------------------------------------------------------------------
# Web search (strategy d's external arm)
# ---------------------------------------------------------------------------
# Reference parity: corpus_search_strategy_d.py:461-534 implements
# Google/Vertex web search with a DuckDuckGo fallback, then parallel
# page fetches (:600). Same wire protocols here over urllib: the Google
# Custom Search JSON API and DuckDuckGo's HTML endpoint, selected via
# MRAG_WEB_PROVIDER=google|ddg|google+ddg (the last = Google first,
# DDG when Google errors or returns nothing — the reference's fallback
# shape). Contract-tested against local fake servers
# (tests/test_web_providers.py); the agent keeps OfflineWebStub when
# the env var is unset, so zero-egress runs are unchanged.


def _get_text(url: str, headers: dict[str, str], *, timeout_s: float,
              max_retries: int = 2, backoff_s: float = 0.5) -> str:
    last: Exception | None = None
    for attempt in range(max_retries + 1):
        try:
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                charset = resp.headers.get_content_charset() or "utf-8"
                return resp.read().decode(charset, errors="replace")
        except urllib.error.HTTPError as e:
            if e.code < 500 and e.code != 429:
                raise LLMHTTPError(f"HTTP {e.code} from {url}") from e
            last = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = e
        if attempt < max_retries:
            time.sleep(backoff_s * (2 ** attempt))
    raise LLMHTTPError(f"{url} unreachable: {last}")


class GoogleCSEWebClient:
    """Google Custom Search JSON API:
    ``GET {base}/customsearch/v1?key=…&cx=…&q=…&num=N`` →
    {"items": [{"title", "link", "snippet"}]}.

    Env: MRAG_GOOGLE_CSE_KEY, MRAG_GOOGLE_CSE_CX,
    MRAG_GOOGLE_CSE_BASE_URL (default https://www.googleapis.com)."""

    offline = False

    def __init__(self, *, base_url: str | None = None, key: str | None = None,
                 cx: str | None = None, timeout_s: float = 10.0):
        self.base_url = (base_url or os.getenv(
            "MRAG_GOOGLE_CSE_BASE_URL", "https://www.googleapis.com")
        ).rstrip("/")
        self.key = key or os.getenv("MRAG_GOOGLE_CSE_KEY", "")
        self.cx = cx or os.getenv("MRAG_GOOGLE_CSE_CX", "")
        if not self.key or not self.cx:
            raise ValueError(
                "GoogleCSEWebClient needs MRAG_GOOGLE_CSE_KEY and "
                "MRAG_GOOGLE_CSE_CX")
        self.timeout_s = timeout_s

    def search(self, query: str, *, max_results: int = 5
               ) -> list[dict[str, str]]:
        import urllib.parse

        qs = urllib.parse.urlencode({
            "key": self.key, "cx": self.cx, "q": query,
            "num": min(max_results, 10)})
        body = json.loads(_get_text(
            f"{self.base_url}/customsearch/v1?{qs}", {},
            timeout_s=self.timeout_s))
        out = []
        for item in body.get("items", [])[:max_results]:
            out.append({"title": item.get("title", ""),
                        "url": item.get("link", ""),
                        "snippet": item.get("snippet", "")})
        return out

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        return _get_text(url, {"User-Agent": _UA}, timeout_s=timeout_s)


_UA = "Mozilla/5.0 (compatible; mobius-rag-tpu/1.0)"

# DuckDuckGo HTML endpoint result anchors: class="result__a" with the
# target (possibly via the /l/?uddg= redirect), snippet in
# class="result__snippet".
_DDG_A = re.compile(
    r'<a[^>]*class="[^"]*result__a[^"]*"[^>]*href="([^"]+)"[^>]*>(.*?)</a>',
    re.S)
_DDG_SNIPPET = re.compile(
    r'class="[^"]*result__snippet[^"]*"[^>]*>(.*?)</(?:a|div|span)>', re.S)
_TAGS = re.compile(r"<[^>]+>")


class DDGHTMLWebClient:
    """DuckDuckGo HTML endpoint: ``GET {base}/html/?q=…`` parsed with
    regexes (the endpoint is plain server-rendered HTML). Result hrefs
    that go through the ``/l/?uddg=<urlencoded>`` redirect are
    unwrapped. Env: MRAG_DDG_BASE_URL (default
    https://html.duckduckgo.com)."""

    offline = False

    def __init__(self, *, base_url: str | None = None,
                 timeout_s: float = 10.0):
        self.base_url = (base_url or os.getenv(
            "MRAG_DDG_BASE_URL", "https://html.duckduckgo.com")).rstrip("/")
        self.timeout_s = timeout_s

    def search(self, query: str, *, max_results: int = 5
               ) -> list[dict[str, str]]:
        import html as _html
        import urllib.parse

        page = _get_text(
            f"{self.base_url}/html/?q={urllib.parse.quote_plus(query)}",
            {"User-Agent": _UA}, timeout_s=self.timeout_s)
        snippets = [_html.unescape(_TAGS.sub("", s)).strip()
                    for s in _DDG_SNIPPET.findall(page)]
        out = []
        for i, (href, title_html) in enumerate(_DDG_A.findall(page)):
            if len(out) >= max_results:
                break
            url = _html.unescape(href)
            if "uddg=" in url:
                q = urllib.parse.urlparse(url).query
                target = urllib.parse.parse_qs(q).get("uddg", [""])[0]
                url = target or url
            title = _html.unescape(_TAGS.sub("", title_html)).strip()
            out.append({"title": title, "url": url,
                        "snippet": snippets[i] if i < len(snippets) else ""})
        return out

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        return _get_text(url, {"User-Agent": _UA}, timeout_s=timeout_s)


class FallbackWebClient:
    """Primary-then-fallback chain (the reference's Google → DDG shape,
    strategy_d.py:461-534): fall through when the primary raises or
    returns no results."""

    offline = False

    def __init__(self, primary, fallback):
        self.primary, self.fallback = primary, fallback

    def search(self, query: str, *, max_results: int = 5
               ) -> list[dict[str, str]]:
        try:
            out = self.primary.search(query, max_results=max_results)
            if out:
                return out
        except Exception:
            pass
        return self.fallback.search(query, max_results=max_results)

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        try:
            return self.primary.fetch(url, timeout_s=timeout_s)
        except Exception:
            return self.fallback.fetch(url, timeout_s=timeout_s)



def get_web_client():
    """Env-selected web transport (MRAG_WEB_PROVIDER): "google" |
    "ddg" | "google+ddg" (Google primary, DDG fallback). Returns None
    when unset — the agent keeps its zero-egress OfflineWebStub."""
    sel = os.getenv("MRAG_WEB_PROVIDER", "").strip().lower()
    if not sel:
        return None
    if sel == "google":
        return GoogleCSEWebClient()
    if sel == "ddg":
        return DDGHTMLWebClient()
    if sel in ("google+ddg", "google,ddg", "chain"):
        return FallbackWebClient(GoogleCSEWebClient(), DDGHTMLWebClient())
    raise ValueError(
        f"MRAG_WEB_PROVIDER={sel!r} must be google|ddg|google+ddg")
