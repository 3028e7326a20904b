"""Paragraph chunking: page markdown → paragraph chunks.

Reference parity (app/services/chunking.py + page_to_markdown.py):
- raw page text → markdown with header detection (short ALL-CAPS /
  Title-Case lines become `#`/`##` headings);
- blank-line paragraph split carrying a section path (the chain of
  headings above the paragraph) and character offsets;
- code-list fragment gluing (chunking.py:26-96): a short paragraph that
  carries an HCPCS/CPT code AND reads like a continuation or changelog
  row ("and G0659.", "Added HCPCS code [Q5129]. 04.17.23") is glued back
  onto the preceding same-section paragraph so the code stays with its
  row — severed fragments are unretrievable otherwise.

Ported from ``mobius_rag_tpu.ingest.chunking`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import re

# HCPCS (letter + 4 digits) or bare 5-digit CPT.
_CODE_TOKEN_RE = re.compile(r"\b(?:[A-Z]\d{4}|\d{5})\b")
# Revision-log verb paired with a code reference.
_CHANGELOG_RE = re.compile(
    r"(?i)\b(?:add(?:ed)?|remov(?:ed)?|updat(?:ed)?|revis(?:ed)?|"
    r"delet(?:ed)?|replac(?:ed)?|correct(?:ed)?)\b[^.\n]*\b(?:hcpcs|cpt|code)\b"
)
# Continuation-style opening: lowercase start, opening bracket/paren, or a
# lowercase connector. Case-sensitive on purpose — uppercase-initial short
# lines are self-contained entries, not severed continuations.
_CONTINUATION_START_RE = re.compile(r"^(?:[a-z(\[]|(?:and|or|to|through|thru)\b)")
GLUE_MAX_FRAGMENT_LEN = 40

_HEADING_MD_RE = re.compile(r"^(#{1,6})\s+(.*)$")
_ALL_CAPS_RE = re.compile(r"^[A-Z0-9][A-Z0-9 \-/&.,:()]{3,79}$")
_TITLE_CASE_RE = re.compile(r"^(?:[A-Z][a-zA-Z0-9'&/-]*\s+){0,7}[A-Z][a-zA-Z0-9'&/-]*:?$")


@dataclasses.dataclass
class Paragraph:
    text: str
    section_path: str
    paragraph_index: int
    start_offset: int
    end_offset: int
    page: int = 0


def page_to_markdown(text: str) -> str:
    """Raw page text → markdown with header detection. A line becomes a
    heading when it's short, unterminated, and ALL-CAPS (`#`) or
    Title-Case (`##`) — the page_to_markdown.py heuristic."""
    out = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            out.append("")
            continue
        if _HEADING_MD_RE.match(stripped):
            out.append(stripped)
        elif len(stripped) <= 80 and not stripped.endswith((".", ";", ",")):
            if _ALL_CAPS_RE.match(stripped) and any(c.isalpha() for c in stripped):
                out.append(f"# {stripped.rstrip(':')}")
            elif _TITLE_CASE_RE.match(stripped) and len(stripped.split()) >= 2:
                out.append(f"## {stripped.rstrip(':')}")
            else:
                out.append(stripped)
        else:
            out.append(stripped)
    return "\n".join(out)


def is_code_list_fragment(text: str) -> bool:
    t = (text or "").strip()
    if not t or len(t) >= GLUE_MAX_FRAGMENT_LEN:
        return False
    if not _CODE_TOKEN_RE.search(t):
        return False
    return bool(_CHANGELOG_RE.search(t)) or bool(_CONTINUATION_START_RE.match(t))


def split_paragraphs_from_markdown(md: str, page: int = 0) -> list[Paragraph]:
    """Blank-line paragraph split with section-path tracking, then
    code-list fragment gluing."""
    paragraphs: list[Paragraph] = []
    section_stack: list[tuple[int, str]] = []  # (level, title)
    buf: list[str] = []
    buf_start = 0
    offset = 0

    def section_path() -> str:
        return " / ".join(t for _, t in section_stack)

    def flush(end: int):
        nonlocal buf
        text = "\n".join(buf).strip()
        if text:
            paragraphs.append(Paragraph(
                text=text, section_path=section_path(),
                paragraph_index=len(paragraphs),
                start_offset=buf_start, end_offset=end, page=page,
            ))
        buf = []

    for line in md.splitlines(keepends=True):
        stripped = line.strip()
        m = _HEADING_MD_RE.match(stripped)
        if m:
            flush(offset)
            level = len(m.group(1))
            title = m.group(2).strip()
            while section_stack and section_stack[-1][0] >= level:
                section_stack.pop()
            section_stack.append((level, title))
        elif not stripped:
            flush(offset)
        else:
            if not buf:
                buf_start = offset
            buf.append(stripped)
        offset += len(line)
    flush(offset)

    # glue code-list fragments backward into the same-section predecessor
    merged: list[Paragraph] = []
    for p in paragraphs:
        if (merged and is_code_list_fragment(p.text)
                and merged[-1].section_path == p.section_path):
            prev = merged[-1]
            prev.text = f"{prev.text}\n{p.text}"
            prev.end_offset = p.end_offset
        else:
            merged.append(p)
    for i, p in enumerate(merged):
        p.paragraph_index = i
    return merged


def chunk_pages(pages: list[tuple[int, str]]) -> list[Paragraph]:
    """[(page_number, raw_text)] → paragraphs across the document."""
    out: list[Paragraph] = []
    for num, text in pages:
        md = page_to_markdown(text)
        for p in split_paragraphs_from_markdown(md, page=num):
            p.paragraph_index = len(out)
            out.append(p)
    return out
