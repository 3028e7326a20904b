"""Query-bank loader (the port of ``mobius_rag_tpu.eval_harness.bank``).

Format-compatible with the reference's banks (eval/queries_cmhc.yaml:
bank_version + queries[] with id/persona/query/expected/golden_answer/
must_facts/bonus_facts/forbidden_facts/golden_citation), including the
expected-key folding the reference does at load (eval/run.py:68-87:
rubric fields are folded INTO the `expected` dict; skipping this
silently disables rubric judging).

The banks shipped with the port are JSON copies of the JAX package's YAML
banks (``data/bank_*.json``): each carries its source's file name,
``bank_version`` and sha (the first 16 hex digits of the YAML bytes'
sha256), so an eval row records the same bank sha in both packages. A
``.yaml`` bank (the reference's, under ``Config.eval_bank_dir``, or an
editable one) is read through PyYAML, imported only then.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

from mobius_rag_tpu_torch.config import get_config

_RUBRIC_KEYS = ("golden_answer", "must_facts", "bonus_facts", "forbidden_facts",
                "golden_citation", "expected_contour")
DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@dataclasses.dataclass
class BankQuery:
    id: str
    query: str
    persona: str = ""
    payer_specificity: str = ""
    expected: dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: str = ""
    raw: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def must_facts(self) -> list[str]:
        return list(self.expected.get("must_facts") or [])

    @property
    def bonus_facts(self) -> list[str]:
        return list(self.expected.get("bonus_facts") or [])

    @property
    def forbidden_facts(self) -> list[str]:
        return list(self.expected.get("forbidden_facts") or [])

    @property
    def golden_answer(self) -> str:
        return self.expected.get("golden_answer") or ""


@dataclasses.dataclass
class Bank:
    name: str
    version: str
    sha: str
    queries: list[BankQuery]


def _candidates(name: str) -> list[str]:
    """Where a short name resolves: the reference banks under
    ``eval_bank_dir`` (YAML), then the port's JSON copies."""
    stem = name[:-5] if name.endswith((".yaml", ".json")) else name
    ref = get_config().eval_bank_dir
    return [os.path.join(ref, f"{stem}.yaml"), os.path.join(ref, f"queries_{stem}.yaml"),
            os.path.join(DATA_DIR, f"{stem}.json"), os.path.join(DATA_DIR, f"bank_{stem}.json")]


def load_bank(path_or_name: str) -> Bank:
    """Load a bank by path, or by short name resolved against
    Config.eval_bank_dir (reference banks) then the port's data dir."""
    candidates = [path_or_name]
    if not os.path.exists(path_or_name):
        candidates = _candidates(path_or_name)
    path = next((c for c in candidates if os.path.exists(c)), None)
    if path is None:
        raise FileNotFoundError(f"no bank found for {path_or_name!r} in {candidates}")

    with open(path, "rb") as f:
        blob = f.read()
    name, sha = os.path.basename(path), hashlib.sha256(blob).hexdigest()[:16]
    if path.endswith(".json"):
        raw = json.loads(blob) or {}
        # a copy of a YAML bank names its source and carries its sha
        name, sha = raw.get("name", name), raw.get("sha", sha)
    else:
        import yaml

        raw = yaml.safe_load(blob) or {}
    queries = []
    for item in raw.get("queries", []):
        expected = dict(item.get("expected") or {})
        # fold rubric fields into expected (run.py:68-87 contract)
        for key in _RUBRIC_KEYS:
            if key in item and key not in expected:
                expected[key] = item[key]
        queries.append(BankQuery(
            id=str(item.get("id", f"q{len(queries)}")),
            query=item.get("query", ""),
            persona=item.get("persona", ""),
            payer_specificity=item.get("payer_specificity", ""),
            expected=expected,
            notes=item.get("notes", ""),
            raw=item,
        ))
    return Bank(name=name, version=str(raw.get("bank_version", "unversioned")), sha=sha,
                queries=queries)
