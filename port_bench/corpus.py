"""A configuration's corpus, made from the seed: the rows on the device,
and each row's fields by the configuration's rules. Both the system under
test and the reference are handed what this module makes; it imports
nothing of either."""
from __future__ import annotations

import torch

BLOCK = 125_000  # rows made per step on the device


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one purpose (`salt`) of a run's
    seed; any whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def make_vectors(spec: dict, device, seed: int) -> torch.Tensor:
    """[rows, dim] bfloat16 unit rows: `centers` unit centers plus
    `noise` N(0, 1) per dimension, normalized (bench_1m_e2e.py's corpus),
    made in a few large calls on `device` from the run's seed. Every seed
    has the same sizes; the rows, and with them the ANN tables, differ."""
    n, d = spec["rows"], spec["dim"]
    g = generator(seed, 1, device)
    centers = torch.randn((spec["centers"], d), device=device, generator=g)
    centers /= centers.norm(dim=1, keepdim=True)
    out = torch.empty((n, d), dtype=torch.bfloat16, device=device)
    for lo in range(0, n, BLOCK):
        m = min(BLOCK, n - lo)
        pick = torch.randint(0, spec["centers"], (m,), device=device, generator=g)
        v = centers[pick] + spec["noise"] * torch.randn((m, d), device=device, generator=g)
        out[lo:lo + m] = (v / v.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return out


def payer(spec: dict, i: int) -> str:
    return spec["payers"][i % len(spec["payers"])]


def authority_level(spec: dict, i: int) -> int:
    return i % spec["authority_levels"]


def dtag(spec: dict, i: int) -> int:
    return i % spec["dtag_cycle"]


def doc(spec: dict, i: int) -> str:
    return f"doc{i % spec['docs']}"


def text_index(spec: dict, i: int) -> int:
    """Which of the configuration's `texts` row i carries: one text for
    each run of `featurize_every` rows, cycling over the texts, so that
    the featurized rows hold every text with every payer they have."""
    return (i // spec["featurize_every"]) % len(spec["texts"])


def text(spec: dict, i: int) -> str:
    return spec["texts"][text_index(spec, i)]


def featurized(spec: dict, i: int) -> bool:
    """Every `featurize_every`-th row carries lexical weights and lexicon
    tags from its text; the others carry their d-tag alone."""
    return i % spec["featurize_every"] == 0


def haystack(spec: dict, body: str, payer_name: str) -> str:
    """A featurized row's tagging haystack: its text and its metadata
    (payer with spaces, state), one per line."""
    parts = [body, payer_name.replace("_", " "), spec["state"]]
    return "\n".join(p for p in parts if p)
