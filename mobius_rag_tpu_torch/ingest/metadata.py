"""Payer/state/program canonicalization (reference:
app/services/metadata_canonical.py, 282 LoC): free-form operator input
→ canonical snake_case forms so filters and interners converge.

Ported from ``mobius_rag_tpu.ingest.metadata`` with the port's imports.
"""
from __future__ import annotations

import re

_PAYER_ALIASES = {
    "sunshine": "sunshine_health",
    "sunshine health": "sunshine_health",
    "sunshine health florida": "sunshine_health",
    "aetna": "aetna",
    "aetna better health": "aetna",
    "abh": "aetna",
    "molina": "molina",
    "molina healthcare": "molina",
    "ahca": "ahca",
}

_STATE_ALIASES = {
    "florida": "FL", "fl": "FL", "fla": "FL",
    "georgia": "GA", "ga": "GA",
    "texas": "TX", "tx": "TX",
}

_PROGRAM_ALIASES = {
    "medicaid": "medicaid", "mma": "medicaid",
    "medicaid managed care": "medicaid",
    "medicare": "medicare", "ltc": "ltc", "long term care": "ltc",
    "chip": "chip", "marketplace": "marketplace",
}


def _norm(s: str) -> str:
    # collapse runs of separators: "Sunshine  Health" and "sunshine-health"
    # must converge to one canonical key, not sprout double underscores
    cleaned = re.sub(r"[^a-z0-9 ]+", " ", (s or "").lower())
    return re.sub(r"\s+", " ", cleaned).strip()


def canonical_payer(raw: str) -> str:
    n = _norm(raw)
    if not n:
        return ""
    return _PAYER_ALIASES.get(n, n.replace(" ", "_"))


def canonical_state(raw: str) -> str:
    n = _norm(raw)
    if not n:
        return ""
    return _STATE_ALIASES.get(n, raw.strip().upper()[:2] if len(raw.strip()) <= 3 else n.upper())


def canonical_program(raw: str) -> str:
    n = _norm(raw)
    if not n:
        return ""
    return _PROGRAM_ALIASES.get(n, n.replace(" ", "_"))


def canonicalize_metadata(*, payer: str = "", state: str = "", program: str = "") -> dict[str, str]:
    return {
        "payer": canonical_payer(payer),
        "state": canonical_state(state),
        "program": canonical_program(program),
    }
