"""Markdown → PDF export (the port of ``mobius_rag_tpu.export_pdf``;
reference: app/services/markdown_to_pdf.py:16, which shells out to
xhtml2pdf). A minimal self-contained PDF 1.4 writer with no rendering
stack: headings, paragraphs and bullet lists in Helvetica, A4 pages, word
wrapping; its bytes equal the JAX package's for the same input. Enough
for the "download the consolidated document as PDF" operator workflow; a
real renderer can take its place behind the same function signature."""
from __future__ import annotations

import re
import zlib

_PAGE_W, _PAGE_H = 595, 842  # A4 points
_MARGIN = 56
_LINE_H = {"h1": 22, "h2": 18, "h3": 16, "p": 13, "li": 13}
_FONT_SZ = {"h1": 17, "h2": 14, "h3": 12.5, "p": 10.5, "li": 10.5}
_CHARS_PER_LINE = {"h1": 52, "h2": 64, "h3": 72, "p": 88, "li": 84}


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def _wrap(text: str, width: int) -> list[str]:
    words = text.split()
    lines, cur = [], ""
    for w in words:
        if len(cur) + len(w) + 1 > width and cur:
            lines.append(cur)
            cur = w
        else:
            cur = f"{cur} {w}".strip()
    if cur:
        lines.append(cur)
    return lines or [""]


def markdown_to_pdf(md: str, title: str = "document") -> bytes:
    """Render markdown text to PDF bytes."""
    # parse into (kind, text) blocks
    blocks: list[tuple[str, str]] = []
    for raw in md.splitlines():
        line = raw.rstrip()
        if not line.strip():
            continue
        m = re.match(r"^(#{1,3})\s+(.*)", line)
        if m:
            blocks.append((f"h{len(m.group(1))}", m.group(2)))
        elif re.match(r"^\s*[-*+]\s+", line):
            blocks.append(("li", re.sub(r"^\s*[-*+]\s+", "• ", line)))
        else:
            blocks.append(("p", line.strip()))

    # paginate into content streams
    pages: list[list[str]] = []
    ops: list[str] = []
    y = _PAGE_H - _MARGIN

    def flush_page():
        nonlocal ops, y
        if ops:
            pages.append(ops)
        ops = []
        y = _PAGE_H - _MARGIN

    for kind, text in blocks:
        bold = kind.startswith("h")
        for line in _wrap(text, _CHARS_PER_LINE[kind]):
            if y < _MARGIN + _LINE_H[kind]:
                flush_page()
            font = "/F2" if bold else "/F1"
            ops.append(
                f"BT {font} {_FONT_SZ[kind]} Tf {_MARGIN} {y:.1f} Td "
                f"({_escape(line)}) Tj ET"
            )
            y -= _LINE_H[kind]
        y -= 4  # block spacing
    flush_page()
    if not pages:
        pages = [[f"BT /F1 10.5 Tf {_MARGIN} {_PAGE_H - _MARGIN} Td (empty) Tj ET"]]

    # assemble the PDF object graph
    objs: list[bytes] = []

    def add(obj: str | bytes) -> int:
        objs.append(obj.encode() if isinstance(obj, str) else obj)
        return len(objs)  # 1-based object number

    font1 = add("<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    font2 = add("<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold >>")
    page_ids = []
    content_ids = []
    for stream_ops in pages:
        data = zlib.compress("\n".join(stream_ops).encode())
        content_ids.append(add(
            f"<< /Length {len(data)} /Filter /FlateDecode >>\nstream\n".encode()
            + data + b"\nendstream"
        ))
    pages_id = len(objs) + len(pages) + 1
    for cid in content_ids:
        page_ids.append(add(
            f"<< /Type /Page /Parent {pages_id} 0 R /MediaBox [0 0 {_PAGE_W} {_PAGE_H}] "
            f"/Contents {cid} 0 R /Resources << /Font << /F1 {font1} 0 R "
            f"/F2 {font2} 0 R >> >> >>"
        ))
    kids = " ".join(f"{p} 0 R" for p in page_ids)
    assert add(f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>") == pages_id
    catalog = add(f"<< /Type /Catalog /Pages {pages_id} 0 R >>")

    out = bytearray(b"%PDF-1.4\n")
    offsets = [0]
    for i, obj in enumerate(objs, start=1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref_at = len(out)
    out += f"xref\n0 {len(objs) + 1}\n".encode()
    out += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root {catalog} 0 R >>\n"
            f"startxref\n{xref_at}\n%%EOF").encode()
    return bytes(out)
