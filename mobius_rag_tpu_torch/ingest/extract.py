"""Document text extraction: bytes → per-page text.

Reference parity: app/services/extract_text.py (PDF via PyMuPDF, HTML
via BeautifulSoup, TXT passthrough; per-page error status) and
app/services/html_extractor.py (raw HTML → per-<h1-h3> sections shaped
like PDF pages with the heading CHAIN as the section path).

PDF extraction prefers PyMuPDF when installed; otherwise a built-in
pure-Python extractor handles the common case (FlateDecode/raw content
streams, literal/hex/TJ-array show-text operators, standard one-byte
encodings). CID/Type0-subset fonts need PyMuPDF — those pages carry a
per-page error status instead of silently yielding mojibake.

Ported from ``mobius_rag_tpu.ingest.extract`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import re
import zlib


@dataclasses.dataclass
class ExtractedPage:
    number: int  # 1-based
    text: str
    section: str = ""
    error: str = ""


@dataclasses.dataclass
class ExtractedDoc:
    pages: list[ExtractedPage]
    kind: str  # pdf | html | txt | md
    warnings: list[str] = dataclasses.field(default_factory=list)


_PAGE_BREAK = re.compile(r"\f")


def _extract_txt(data: bytes) -> ExtractedDoc:
    text = data.decode("utf-8", errors="replace")
    chunks = _PAGE_BREAK.split(text) if "\f" in text else [text]
    pages = [ExtractedPage(i + 1, c.strip()) for i, c in enumerate(chunks) if c.strip()]
    return ExtractedDoc(pages or [ExtractedPage(1, "")], "txt")


def _extract_html(data: bytes) -> ExtractedDoc:
    """Per-heading sections shaped like pages (html_extractor.py:1-326
    behavior: each h1–h3 starts a new 'page' whose section path is the
    heading chain)."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(data, "lxml")
    for tag in soup(["script", "style", "nav", "footer", "header"]):
        tag.decompose()
    body = soup.body or soup

    pages: list[ExtractedPage] = []
    current: list[str] = []
    # heading CHAIN: the section path is "H1 > H2 > H3" down to the
    # current heading's level (html_extractor.py's section shaping)
    chain: dict[int, str] = {}
    section = ""

    def flush():
        nonlocal current
        text = "\n".join(t for t in current if t.strip()).strip()
        if text:
            pages.append(ExtractedPage(len(pages) + 1, text, section=section))
        current = []

    for el in body.descendants:
        name = getattr(el, "name", None)
        if name in ("h1", "h2", "h3"):
            flush()
            level = int(name[1])
            heading = el.get_text(" ", strip=True)
            chain[level] = heading
            for deeper in (2, 3):
                if deeper > level:
                    chain.pop(deeper, None)
            section = " > ".join(chain[i] for i in sorted(chain))
            current.append(f"{'#' * level} {heading}")
        elif name in ("p", "li", "td", "th", "pre"):
            txt = el.get_text(" ", strip=True)
            if txt:
                current.append(txt)
    flush()
    if not pages:
        text = body.get_text("\n", strip=True)
        pages = [ExtractedPage(1, text)]
    return ExtractedDoc(pages, "html")


# ---------------------------------------------------------------------------
# Built-in PDF text extraction (no native deps)
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+\d+\s+obj(.*?)endobj", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
# show-text operators inside a decoded content stream
_TJ_LIT_RE = re.compile(rb"\(((?:\\.|[^\\()])*)\)\s*Tj")
_TJ_HEX_RE = re.compile(rb"<([0-9A-Fa-f\s]+)>\s*Tj")
_TJ_ARR_RE = re.compile(rb"\[((?:\\.|[^\]])*)\]\s*TJ")
_ARR_LIT_RE = re.compile(rb"\(((?:\\.|[^\\()])*)\)")
_NEWLINE_OPS_RE = re.compile(rb"\bT\*|\bTd\b|\bTD\b")
_PDF_ESCAPES = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                b"f": b"\f", b"(": b"(", b")": b")", b"\\": b"\\"}


def _unescape_pdf_string(raw: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i:i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1:i + 2]
            if nxt.isdigit():  # octal \ddd (1-3 digits)
                j = i + 1
                while j < min(i + 4, len(raw)) and raw[j:j + 1].isdigit():
                    j += 1
                out.append(int(raw[i + 1:j], 8) & 0xFF)
                i = j
                continue
            out += _PDF_ESCAPES.get(nxt, nxt)
            i += 2
            continue
        out += c
        i += 1
    return out.decode("latin-1", errors="replace")


def _content_stream_text(decoded: bytes) -> str:
    """Pull show-text runs out of one decoded content stream, inserting
    line breaks at text-positioning operators between runs."""
    events: list[tuple[int, str]] = []
    for m in _TJ_LIT_RE.finditer(decoded):
        events.append((m.start(), _unescape_pdf_string(m.group(1))))
    for m in _TJ_HEX_RE.finditer(decoded):
        hexs = re.sub(rb"\s", b"", m.group(1))
        try:
            events.append((m.start(), bytes.fromhex(hexs.decode()).decode(
                "latin-1", errors="replace")))
        except ValueError:
            pass
    for m in _TJ_ARR_RE.finditer(decoded):
        parts = [_unescape_pdf_string(x.group(1))
                 for x in _ARR_LIT_RE.finditer(m.group(1))]
        events.append((m.start(), "".join(parts)))
    breaks = {m.start() for m in _NEWLINE_OPS_RE.finditer(decoded)}
    events.sort()
    lines: list[str] = []
    buf = ""
    prev_end = 0
    for pos, txt in events:
        if buf and any(prev_end <= bp < pos for bp in breaks):
            lines.append(buf)
            buf = ""
        buf += txt
        prev_end = pos
    if buf:
        lines.append(buf)
    return "\n".join(lines).strip()


def _extract_pdf_builtin(data: bytes) -> ExtractedDoc:
    """Pure-Python PDF text extraction: walk objects, decode Flate/raw
    content streams, read the show-text operators. Pages are resolved
    through /Type /Page objects' /Contents references; falls back to
    one page per content stream when the page tree can't be parsed."""
    objects: dict[int, bytes] = {}
    streams: dict[int, bytes] = {}
    warnings: list[str] = []
    for m in _OBJ_RE.finditer(data):
        num = int(m.group(1))
        body = m.group(2)
        objects[num] = body
        sm = _STREAM_RE.search(body)
        if sm:
            raw = sm.group(1)
            if b"/FlateDecode" in body[: sm.start()]:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    warnings.append(f"object {num}: flate error {e}")
                    continue
            streams[num] = raw

    # page order via /Type /Page → /Contents N 0 R
    page_contents: list[tuple[int, str]] = []  # (object num, error)
    for num, body in sorted(objects.items()):
        head = body.split(b"stream", 1)[0]
        if b"/Type" in head and re.search(rb"/Type\s*/Page\b(?!s)", head):
            cm = re.search(rb"/Contents\s+(\d+)\s+\d+\s+R", head)
            if cm:
                page_contents.append((int(cm.group(1)), ""))
            else:
                page_contents.append((-1, "page without /Contents reference"))
    if not page_contents:  # no parseable page tree: stream order
        page_contents = [(num, "") for num in sorted(streams)]

    pages: list[ExtractedPage] = []
    for i, (cnum, err) in enumerate(page_contents):
        if err or cnum not in streams:
            pages.append(ExtractedPage(i + 1, "", error=err or
                                       f"missing content stream {cnum}"))
            continue
        text = _content_stream_text(streams[cnum])
        if not text:
            pages.append(ExtractedPage(
                i + 1, "", error="no extractable show-text operators "
                "(CID/Type0 fonts need PyMuPDF)"))
            continue
        pages.append(ExtractedPage(i + 1, text))
    if not any(p.text for p in pages):
        warnings.append("builtin extractor found no text")
    return ExtractedDoc(pages or [ExtractedPage(1, "", error="empty pdf")],
                        "pdf", warnings)


def _extract_pdf(data: bytes) -> ExtractedDoc:
    try:
        import fitz  # PyMuPDF — richer extraction when available
    except ImportError:
        return _extract_pdf_builtin(data)
    doc = fitz.open(stream=data, filetype="pdf")
    pages = []
    warnings = []
    for i, page in enumerate(doc):
        try:
            pages.append(ExtractedPage(i + 1, page.get_text("text")))
        except Exception as e:  # per-page error status, keep going
            pages.append(ExtractedPage(i + 1, "", error=str(e)))
            warnings.append(f"page {i + 1}: {e}")
    return ExtractedDoc(pages, "pdf", warnings)


def sniff_kind(filename: str, data: bytes) -> str:
    name = filename.lower()
    if name.endswith(".pdf") or data[:5] == b"%PDF-":
        return "pdf"
    if name.endswith((".html", ".htm")) or b"<html" in data[:2048].lower():
        return "html"
    if name.endswith((".md", ".markdown")):
        return "md"
    return "txt"


def extract_text_from_bytes(data: bytes, filename: str = "") -> ExtractedDoc:
    kind = sniff_kind(filename, data)
    if kind == "pdf":
        return _extract_pdf(data)
    if kind == "html":
        return _extract_html(data)
    doc = _extract_txt(data)
    return dataclasses.replace(doc, kind=kind)
