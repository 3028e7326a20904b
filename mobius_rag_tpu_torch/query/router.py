"""Strategy router v1 + v2 (the port of
``mobius_rag_tpu.query.router``).

Semantics follow the reference's router (app/services/
corpus_search_router.py): calibrated priors per (strategy × query_class),
a canonical-policy blend for thematic queries, a risk-adjusted additive
score (accuracy·need + recall·demand + speed·weight + shape match), a
recall-withdrawal threshold, a linear-feature scoring variant, and the v2
action-tree multi-invoke rule (top-2 gap < 0.08 and both > 0.30 → run
both arms and union; corpus_search_router_v2.py:1-143).

Priors are DATA, not code: loaded from data/router_priors.json (versioned
by priors_version), regenerated by eval_harness.derive_priors from
calibration runs — the reference's derive_priors.py contract.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

STRATEGIES = ("a", "b", "c", "d")

_SPEED_WEIGHT = {"real_time": 1.0, "interactive": 0.5, "batch": 0.1}
SHAPE_MATCH_WEIGHT = 0.30
WITHDRAW_RECALL_THRESHOLD = 0.05
# v2 multi-invoke rule
V2_GAP = 0.08
V2_FLOOR = 0.30
# v2: weight of the linear feature model blended into the prior score
LINEAR_BLEND_V2 = 0.30


@dataclasses.dataclass(frozen=True)
class StrategyPrior:
    shapes: tuple[str, ...] = ("structured",)
    accuracy: float = 0.3
    accuracy_std: float = 0.2
    recall_capacity: float = 0.5
    recall_std: float = 0.0
    speed: float = 0.5
    cost_per_call: float = 0.0


@dataclasses.dataclass
class RoutePreferences:
    accuracy_need: float = 0.5
    recall_demand: float = 0.5
    speed_budget: str = "real_time"
    answer_shape: str | None = None


# Caller-mode preset table (corpus_search_router.py:118-160): named
# caller contexts resolve to preference defaults; explicit per-request
# fields always win over the preset.
CALLER_MODE_PRESETS: dict[str, RoutePreferences] = {
    "default": RoutePreferences(),
    # interactive chat: balanced, willing to wait a moment
    "chat_interactive": RoutePreferences(
        accuracy_need=0.5, recall_demand=0.5, speed_budget="interactive"),
    # claims/UM adjudication support: trust the LOWER accuracy band,
    # prefer abstain over plausible-wrong
    "high_stakes": RoutePreferences(
        accuracy_need=0.9, recall_demand=0.7, speed_budget="interactive"),
    # offline eval sweeps: recall matters, latency doesn't
    "bulk_eval": RoutePreferences(
        accuracy_need=0.5, recall_demand=0.8, speed_budget="batch"),
    # autocomplete-grade point lookups: fast, structured, shallow
    "quick_lookup": RoutePreferences(
        accuracy_need=0.4, recall_demand=0.3, speed_budget="real_time",
        answer_shape="structured"),
    # analyst research: exhaustive, any shape
    "research": RoutePreferences(
        accuracy_need=0.6, recall_demand=0.9, speed_budget="batch",
        answer_shape="any"),
}


def resolve_preferences(
    caller_mode: str | None = None,
    *,
    accuracy_need: float | None = None,
    recall_demand: float | None = None,
    speed_budget: str | None = None,
    answer_shape: str | None = None,
) -> RoutePreferences:
    """Preference resolution (router :162): start from the caller-mode
    preset, overlay any explicitly-given fields. Unknown modes fail loud
    — a typo'd caller mode silently routing as 'default' was a reference
    postmortem class."""
    base = CALLER_MODE_PRESETS.get(caller_mode or "default")
    if base is None:
        raise ValueError(
            f"unknown caller_mode {caller_mode!r}; known: "
            f"{sorted(CALLER_MODE_PRESETS)}")
    overrides = {k: v for k, v in (
        ("accuracy_need", accuracy_need), ("recall_demand", recall_demand),
        ("speed_budget", speed_budget), ("answer_shape", answer_shape),
    ) if v is not None}
    return dataclasses.replace(base, **overrides)


@dataclasses.dataclass
class RouteDecision:
    strategy: str
    order: list[str]  # full fallback order (withdrawn excluded)
    scores: dict[str, float]
    withdrawn: list[str]
    multi_invoke: list[str]  # v2: strategies to run together (incl. winner)
    priors_version: str
    reason: str


def _default_priors_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "data", "router_priors.json")


class Router:
    def __init__(self, priors_path: str | None = None, version: str = "v1"):
        self.version = version
        path = priors_path or _default_priors_path()
        with open(path) as f:
            raw = json.load(f)
        self.priors_version = raw["priors_version"]
        self.priors: dict[str, dict[str, StrategyPrior]] = {}
        for sid, classes in raw["priors"].items():
            self.priors[sid] = {
                qc: StrategyPrior(**{**v, "shapes": tuple(v.get("shapes", ("structured",)))})
                for qc, v in classes.items()
            }
        self.canonical: dict[str, StrategyPrior] = {
            sid: StrategyPrior(**{**v, "shapes": tuple(v.get("shapes", ("structured",)))})
            for sid, v in raw.get("canonical", {}).items()
        }

    # -- scoring ----------------------------------------------------------

    @staticmethod
    def _shape_match(prior: StrategyPrior, requested: str | None) -> float:
        if requested is None or requested == "any":
            return 1.0
        return 1.0 if requested in prior.shapes else 0.4

    @staticmethod
    def _blend(base: StrategyPrior, canon: StrategyPrior, w: float) -> StrategyPrior:
        if w <= 0:
            return base
        mix = lambda x, y: (1 - w) * x + w * y
        return StrategyPrior(
            shapes=base.shapes,
            accuracy=mix(base.accuracy, canon.accuracy),
            accuracy_std=mix(base.accuracy_std, canon.accuracy_std),
            recall_capacity=mix(base.recall_capacity, canon.recall_capacity),
            recall_std=mix(base.recall_std, canon.recall_std),
            speed=mix(base.speed, canon.speed),
            cost_per_call=base.cost_per_call,
        )

    def _score(self, prior: StrategyPrior, prefs: RoutePreferences) -> float:
        """Risk-adjusted additive score: high-stakes callers trust the
        LOWER end of the accuracy distribution (risk_k · std penalty)."""
        speed_w = _SPEED_WEIGHT.get(prefs.speed_budget, 1.0)
        risk_k = max(0.0, (prefs.accuracy_need - 0.5) * 2.0)
        acc_eff = max(0.0, prior.accuracy - risk_k * prior.accuracy_std)
        rec_eff = max(0.0, prior.recall_capacity - risk_k * prior.recall_std)
        return (
            acc_eff * prefs.accuracy_need
            + rec_eff * prefs.recall_demand
            + prior.speed * speed_w
            + self._shape_match(prior, prefs.answer_shape) * SHAPE_MATCH_WEIGHT
            - prior.cost_per_call
        )

    def decide(
        self,
        profile_features: dict[str, Any],
        prefs: RoutePreferences | None = None,
        *,
        exclude: list[str] | None = None,
    ) -> RouteDecision:
        prefs = prefs or RoutePreferences()
        qc = profile_features.get("query_class", "vague")
        canon_w = float(profile_features.get("canonicality", 0.0))
        exclude = exclude or []
        # v2 blends the prior score with the linear feature model
        # (corpus_search_router_v2.py's "linear tweaks" — exclusivity,
        # literal anchors, corpus depth, crawlability adjust the priors
        # instead of replacing them).
        lin_feats = linear_features(profile_features) if self.version == "v2" else None
        # internal recall self-estimate feedback (agent :1503 → router
        # :633): a LOW estimate from the previous attempt boosts the
        # recall demand for the re-route.
        self_est = profile_features.get("recall_self_estimate")
        if self_est is not None and self_est < 0.5:
            prefs = dataclasses.replace(
                prefs, recall_demand=min(1.0, prefs.recall_demand + 0.3))

        scores: dict[str, float] = {}
        withdrawn: list[str] = []
        for sid in STRATEGIES:
            if sid in exclude:
                continue
            base = self.priors.get(sid, {}).get(qc) or StrategyPrior()
            prior = self._blend(base, self.canonical.get(sid, base), canon_w)
            risk_k = max(0.0, (prefs.accuracy_need - 0.5) * 2.0)
            rec_eff = max(0.0, prior.recall_capacity - risk_k * prior.recall_std)
            if rec_eff < WITHDRAW_RECALL_THRESHOLD:
                withdrawn.append(sid)
                continue
            scores[sid] = self._score(prior, prefs)
            if lin_feats is not None:
                scores[sid] += LINEAR_BLEND_V2 * linear_score(sid, lin_feats)

        if not scores:
            # everything withdrew — fall back to (a), the cheap default
            scores = {"a": 0.0}
        order = sorted(scores, key=scores.get, reverse=True)
        winner = order[0]

        multi = [winner]
        if self.version == "v2" and len(order) >= 2:
            second = order[1]
            if (scores[winner] - scores[second] < V2_GAP
                    and scores[winner] > V2_FLOOR and scores[second] > V2_FLOOR):
                multi.append(second)

        reason = (
            f"class={qc} canon={canon_w:.2f} scores="
            + ",".join(f"{s}:{scores[s]:.3f}" for s in order)
            + (f" withdrawn={withdrawn}" if withdrawn else "")
        )
        return RouteDecision(
            strategy=winner, order=order, scores=scores, withdrawn=withdrawn,
            multi_invoke=multi, priors_version=self.priors_version, reason=reason,
        )

    def decide_override(self, forced: str, profile_features: dict[str, Any],
                        prefs: RoutePreferences | None = None) -> RouteDecision:
        """Forced-mode decision (calibration's forced-arm matrix and the
        caller's mode override set)."""
        d = self.decide(profile_features, prefs)
        return dataclasses.replace(
            d, strategy=forced, multi_invoke=[forced],
            order=[forced] + [s for s in d.order if s != forced],
            reason=f"forced={forced}; " + d.reason,
        )


# ---------------------------------------------------------------------------
# Linear-feature scoring variant (stage-1 model; bandit-updatable weights)
# ---------------------------------------------------------------------------

LINEAR_BASE = {"a": 0.40, "b": 0.20, "c": 0.05, "d": 0.20}

LINEAR_WEIGHTS: dict[str, dict[str, float]] = {
    "a": {"exclusivity": 0.30, "literal": 0.25, "corpus_depth": 0.20,
          "thematic_policy": -0.10, "wide_pool": -0.15, "inheritance": 0.05},
    "b": {"thematic_policy": 0.40, "corpus_depth": 0.20, "literal": -0.20,
          "exclusivity": 0.05},
    "c": {},
    "d": {"crawlability": 0.40, "wide_pool": 0.25, "inheritance": -0.25,
          "thematic_policy": -0.20, "corpus_depth": -0.15, "literal": -0.05},
}


def linear_features(profile_features: dict[str, Any]) -> dict[str, float]:
    pool = max(1, int(profile_features.get("pool_size") or 500))
    return {
        "exclusivity": min(1.0, 50.0 / pool),
        "literal": float(bool(profile_features.get("has_literal"))),
        "corpus_depth": float(
            bool(profile_features.get("has_j_payor_tag"))
            and (pool >= 20 or bool(profile_features.get("has_inherited_docs")))
        ),
        "thematic_policy": float(bool(profile_features.get("thematic_policy"))),
        "wide_pool": float(pool > 500),
        "inheritance": float(bool(profile_features.get("has_inherited_docs"))),
        "crawlability": float(profile_features.get("crawlability", 0.3)),
    }


def linear_score(sid: str, feats: dict[str, float]) -> float:
    """Crawlability-dampened linear score: d's corpus_depth/inheritance
    penalties fade as the payer's site becomes genuinely fetchable."""
    score = LINEAR_BASE.get(sid, 0.0)
    crawl = feats.get("crawlability", 0.0)
    for feat, w in LINEAR_WEIGHTS.get(sid, {}).items():
        if sid == "d" and w < 0 and feat in ("corpus_depth", "inheritance"):
            w *= 1.0 - crawl
        score += w * feats.get(feat, 0.0)
    return score
