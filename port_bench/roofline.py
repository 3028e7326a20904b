"""Roofline arithmetic: the least time one H100 could take for a piece of
work, from the operations and bytes its shapes need, against the data
sheet's peaks. Every input byte is counted read once and every output
byte written once, whatever a kernel reads again."""
from __future__ import annotations

# Data-sheet peaks of one NVIDIA H100 SXM at 700 W: HBM bytes/s, and
# dense operations/s by the operands' type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ROW_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# Bytes a row of the index holds in the columns the filter gate and the
# d-tag arm read for every row: validity, payer, state, program and
# authority (4 each), and the j, d and p tag bitsets of `tag_words` words.
GATE_SCALARS = 5 * 4


def least_s(nbytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of the bytes over
    HBM's rate and the operations over their type's peak (summed over
    types)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def topk_work(b: int, c: int, d: int, m: int, dtype: str) -> tuple[float, dict]:
    """The masked top-k of B queries over C rows: rows, queries and the
    [B, C] penalty read once, m (value, id) pairs a query written; 2·B·C·D
    operations at the rows' type."""
    nbytes = c * d * ROW_BYTES[dtype] + b * d * 4 + b * c * 4 + b * m * 8
    if dtype == "int8":
        nbytes += c * 4  # row scales
    kind = "float32" if dtype == "float32" else "bfloat16"
    return nbytes, {kind: 2.0 * b * c * d}


def proj_work(b: int, n_probe: float, scan_rows: float, scan_pairs: float,
              p: int) -> tuple[float, dict]:
    """The probed int8 block dots (proj_blocks) of B queries: the codes
    of the rows that the batch's distinct probed cells hold read once
    (`scan_rows`), the probes (`n_probe` cells a query that hold rows) and
    the int8 queries read, one float32 dot written for each query and row
    of its probed cells (`scan_pairs`); 2·scan_pairs·p int8 operations.
    Empty slots of a cell's padding and empty slabs are not work."""
    nbytes = scan_rows * p + b * n_probe * 4 + b * p + scan_pairs * 4
    return nbytes, {"int8": 2.0 * scan_pairs * p}


def search_work(shape: dict) -> tuple[float, dict]:
    """One batch of the hybrid search, whatever kernels implement it.
    Bytes: every index column the search reads for every row (the gate's
    scalars and tag bitsets; the rows themselves where the exact backend
    scans them), the rows the probed ANN cells hold, the centroids and projection
    (proj), the lexical postings of the batch's buckets, the candidate
    rows and signal columns the fusion gathers, queries in, hits out
    (`postings`: the postings the batch's buckets hold; `cells`: the ANN
    cells that hold rows; `scan_rows`, `scan_pairs` as in proj_work).
    Operations: the vector arm's dots (every row exactly, or the centroid
    scores, the query projection and the probed int8 dots), and the
    candidates' cosines."""
    b, n, d, m, k = shape["batch"], shape["rows"], shape["dim"], shape["m"], shape["k"]
    tw, pw = shape["tag_words"], shape["phrase_words"]
    per_row = GATE_SCALARS + 3 * tw * 4
    cand = b * 3 * m  # candidates of the three arms
    nbytes = n * per_row + b * d * 2 + b * k * 8
    nbytes += shape["postings"] * (4 + 2)  # row id and bf16 weight a posting
    nbytes += cand * (d * ROW_BYTES[shape["dtype"]] + 4 * 2 + pw * 4 + tw * 4 * 2)
    ops = {"bfloat16": 2.0 * cand * d}
    if shape["backend"] == "exact":
        nbytes += n * d * ROW_BYTES[shape["dtype"]]
        ops["bfloat16"] += 2.0 * b * n * d
    else:
        nl, p = shape["cells"], shape["p"]
        # a held row's code, scale and row id; the centroids of the cells
        # that hold rows and the projection
        nbytes += shape["scan_rows"] * (p + 4 * 2) + nl * d * 4 + p * d * 4
        ops["float32"] = 2.0 * b * (nl + p) * d
        ops["int8"] = 2.0 * shape["scan_pairs"] * p
    return nbytes, ops
