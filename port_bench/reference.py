"""The plain reference of one hybrid query, in plain PyTorch over the
corpus that ``corpus.py`` makes. It imports nothing of the system.

For each query it works out, from the configuration, the lexicon file and
the seed's rows:
  filter gate  metadata filter (payer, with regulator-grade rows of no
               payer admitted under inheritance; state; program), the
               strict j-tag and relaxed d/p-tag gates, strict -> relaxed
               auto-relax below k strict rows
  vector arm   exact backend: the cosine of every gate-passing row;
               proj backend: the probed scan of the ANN tables (the
               top-nprobe cells by the reference's own centroid scores
               plus every spill and reserved slab, int8 dots of the
               query's int8 projection with each slot's code, times the
               reference's own scales, plus the centroid score); rows
               under min_similarity are dead
  lexical arm  the query terms' IDF weights against the postings' bf16
               weights, summed in float64 (at most `postings_max` per
               bucket, the heaviest, ties to the earlier row)
  d-tag arm    authority + 1 of every metadata-passing row that shares a
               d-tag with the query
  fusion       RRF (rrf_k) over the three arms' top-m lists, the first m
               fused candidates reranked (reranker v1.3 weights: cosine or
               normalized lexical score, authority, length, d-tag overlap,
               phrase coverage), the top k
Arithmetic is float64 where the system's is float32, so the system's
answers differ from these by rounding. Every selection takes the lower
row (or the lower list position) first among equal values, as the system
states. Of the proj backend's tables the reference takes the system's
slot layout, centroids, projection and codes, and checks each of them
in full against the rows and its definition (``ProjTables.verify``)
before it scans them; it works out the slots' scales, the centroid
scores and the query's projection itself. The exact top k of the
vector arm is worked out beside the scan, for the arm's recall.

``precision="control"`` computes the same in the precision below the
configuration's: int8 rows (per-row symmetric scales) in place of bf16,
and TF32-rounded inputs to the float32 products.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import corpus, reftext

W_SIM, W_AUTH, W_LEN, W_JPD, W_COV = 0.25, 0.10, 0.05, 0.20, 0.55
ARM_WEIGHTS = {"corpus": (1.0, 1.0, 0.5), "precision": (0.5, 1.0, 0.7),
               "recall": (1.0, 0.6, 0.3)}
AUTH_MAX = 4.0
ROW_BLOCK = 131_072  # rows per block of a float64 product
QUERY_BLOCK = 16  # queries per block of [B, rows] masks


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return i.view(torch.float32)


def int8_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows quantized to int8 with a per-row symmetric scale, returned
    dequantized (float32)."""
    x = rows.float()
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12) * np.float32(1 / 127)
    return torch.round(x / scale) * scale


def env_of(cfg: dict, key: str, cast=int):
    return cast(cfg["env"][key])


class RefCorpus:
    """The rows' fields and the lexical postings, made from the
    configuration (``corpus.py``'s rules) and the lexicon file."""

    def __init__(self, cfg: dict, lexicon: reftext.RefLexicon, rows: torch.Tensor,
                 precision: str = "full"):
        spec = cfg["corpus"]
        self.spec, self.lexicon, self.precision = spec, lexicon, precision
        dev = self.device = rows.device
        n = self.n = spec["rows"]
        self.rows = rows if precision == "full" else int8_rows(rows)
        self.k_buckets = env_of(cfg, "MRAG_LEXICAL_BUCKETS")
        i = torch.arange(n, device=dev)
        payers, texts = spec["payers"], spec["texts"]
        self.payer_of = torch.remainder(i, len(payers))  # index into spec payers
        self.payers = payers
        self.text_of = torch.remainder(torch.div(i, spec["featurize_every"],
                                                 rounding_mode="floor"), len(texts))
        levels = torch.remainder(i, spec["authority_levels"]).float()
        self.authority = torch.clamp(levels, 0, AUTH_MAX) / AUTH_MAX
        no_payer = torch.tensor([p == "" for p in payers], device=dev)[self.payer_of]
        self.regulator = (self.authority >= 0.999) & no_payer
        self.length_of = torch.tensor([np.float32(min(len(t) / 600.0, 1.0)) for t in texts],
                                      dtype=torch.float32, device=dev)[self.text_of]
        self.feat = torch.remainder(i, spec["featurize_every"]) == 0
        # tags as bit masks (bit = tag id); featurized rows add their
        # haystack's lexicon tags, which depend on their payer and text
        self.d_mask = torch.bitwise_left_shift(torch.ones_like(i),
                                               torch.remainder(i, spec["dtag_cycle"]))
        self.j_mask = torch.zeros_like(i)
        self.p_mask = torch.zeros_like(i)
        self.phrases_of: dict[tuple[int, int], set[int]] = {}
        for c in range(len(payers)):
            for t, body in enumerate(texts):
                tags = lexicon.tag_text(corpus.haystack(spec, body, payers[c]))
                self.phrases_of[(c, t)] = tags["phrases"]
                sel = self.feat & (self.payer_of == c) & (self.text_of == t)
                for kind, mask in (("j", self.j_mask), ("d", self.d_mask), ("p", self.p_mask)):
                    bits = sum(1 << g for g in tags[kind])
                    if max(tags[kind], default=0) >= 63:
                        raise ValueError("tag ids past 62 do not fit the reference's masks")
                    mask[sel] |= bits
        # lexical postings: a featurized row carries its text's weights
        # (float32, stored as bf16); a bucket keeps its `postings_max`
        # heaviest by the float32 weight, the lower row first among equals
        weights = [reftext.body_weights(t, self.k_buckets) for t in texts]
        feat_rows = torch.nonzero(self.feat).flatten()
        feat_text = self.text_of[feat_rows]
        cap = env_of(cfg, "MRAG_LEXICAL_POSTINGS_MAX")
        self.df, self.postings = {}, {}
        for b in sorted(set().union(*weights)):
            rows_b = torch.cat([feat_rows[feat_text == t] for t, w in enumerate(weights)
                                if b in w])
            w32 = torch.cat([torch.full((int((feat_text == t).sum()),), w[b],
                                        dtype=torch.float32, device=dev)
                             for t, w in enumerate(weights) if b in w])
            order = torch.argsort(rows_b)
            rows_b, w32 = rows_b[order], w32[order]
            keep = torch.sort(-w32, stable=True).indices[:cap]
            self.df[b] = int(rows_b.numel())
            self.postings[b] = (rows_b[keep], w32[keep].to(torch.bfloat16).float())

    def cos(self, q: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
        """float64 cosines of q [B, D] (float64) with every row, or with
        rows idx [B, M]."""
        if idx is not None:
            return torch.einsum("bmd,bd->bm", self.rows[idx].double(), q)
        out = torch.empty((q.shape[0], self.n), dtype=torch.float64, device=self.device)
        for lo in range(0, self.n, ROW_BLOCK):
            out[:, lo:lo + ROW_BLOCK] = q @ self.rows[lo:lo + ROW_BLOCK].double().T
        return out


class Query:
    """One request, prepared as the reference reads it."""

    def __init__(self, rc: RefCorpus, spec: dict, vec: np.ndarray, k: int, min_sim: float):
        self.spec, self.k, self.min_sim = spec, k, min_sim
        exp = rc.lexicon.expand(spec["text"])
        self.j = sum(1 << t for t in exp["tags"]["j"])
        self.d = sum(1 << t for t in exp["tags"]["d"])
        self.p = sum(1 << t for t in exp["tags"]["p"])
        self.slots = exp["slots"]
        self.weights = reftext.query_weights(spec["text"], exp["phrases"], rc.df, rc.n,
                                             rc.k_buckets)
        v = np.asarray(vec, np.float32)
        v = v / np.linalg.norm(v)  # normalized in float32, then sent as bf16
        q = torch.from_numpy(v).to(rc.device).to(torch.bfloat16).float()
        self.vec = (q if rc.precision == "full" else tf32(q)).double()
        self.arm_w = ARM_WEIGHTS[spec["mode"]]


def _gate(rc: RefCorpus, qs: list[Query]):
    """(gate [B, N] bool, metadata [B, N] bool, strict counts [B])."""
    dev = rc.device
    meta = torch.empty((len(qs), rc.n), dtype=torch.bool, device=dev)
    strict = torch.empty_like(meta)
    relaxed = torch.empty_like(meta)
    for b, q in enumerate(qs):
        want = q.spec["payer"]
        if want:
            ids = [c for c, p in enumerate(rc.payers) if p == want]
            m = torch.isin(rc.payer_of, torch.tensor(ids, device=dev, dtype=torch.long))
            meta[b] = m | rc.regulator  # inherit_authority is on
        else:
            meta[b] = True
        strict[b] = meta[b] & (((rc.j_mask & q.j) != 0) if q.j else True)
        relaxed[b] = meta[b] & ((((rc.d_mask & q.d) != 0) | ((rc.p_mask & q.p) != 0))
                                if (q.d or q.p) else True)
    total = strict.sum(dim=1)
    gate = torch.empty_like(meta)
    for b, q in enumerate(qs):
        mode = q.spec["tag_mode"]
        if mode == "strict":
            gate[b] = strict[b] if total[b] >= q.k else strict[b] | relaxed[b]
        elif mode == "relaxed":
            gate[b] = relaxed[b]
        else:
            gate[b] = True
    return gate, meta, total


def _top(vals: torch.Tensor, live: torch.Tensor, m: int):
    """Each row's top m live entries: (values float64, ids), -inf past the
    live ones; equal values keep the lower id first (a stable sort)."""
    v = torch.where(live, vals, torch.tensor(float("-inf"), dtype=vals.dtype,
                                             device=vals.device))
    top_v, top_i = torch.sort(v, dim=1, descending=True, stable=True)
    return top_v[:, :m], top_i[:, :m]


def lexical_scores(rc: RefCorpus, q: Query) -> torch.Tensor:
    """[N] float32 lexical score of every row: float32 products of the
    query weight and the posting's bf16 weight, summed in float64."""
    acc = torch.zeros(rc.n, dtype=torch.float64, device=rc.device)
    for b, w in q.weights.items():
        if b in rc.postings:
            rows, w16 = rc.postings[b]
            acc.index_add_(0, rows, (w16 * np.float32(w)).double())  # float32 products
    return acc.float()


class ProjTables:
    """The proj backend's tables, as the reference reads them. The slot
    layout (row ids, validity), the centroids, the projection and the int8
    codes are the system's build, copied off its objects; ``verify``
    checks every one of them against the rows and its definition, and
    works out each slot's scale again from the rows, so that every score
    the reference gives is its own arithmetic over checked tables."""

    def __init__(self, ann, nprobe: int, choices: int, precision: str = "full"):
        self.nlist, self.pad, self.base = int(ann.nlist), int(ann.pad), int(ann.base_nlist)
        self.reserve_start = int(getattr(ann, "reserve_start", self.nlist))
        self.nprobe, self.choices, self.precision = nprobe, choices, precision
        cent, proj = ann.centroids.float(), ann.proj.float()
        if precision != "full":
            cent, proj = tf32(cent), tf32(proj)
        self.centroids, self.proj = cent.double(), proj.double()
        self.codes = ann.codes.clone()
        self.valid = ann.valid > 0
        self.rowids = ann.rowids.long()
        self.scales = None  # the reference's own, from verify()
        flat_ok = self.valid.flatten()
        slot = torch.nonzero(flat_ok).flatten()
        self.slot_of = torch.full((int(self.rowids.max()) + 1,), -1, dtype=torch.long,
                                  device=slot.device)
        self.slot_of[self.rowids.flatten()[slot]] = slot
        self.count_of = torch.bincount(self.rowids.flatten()[slot],
                                       minlength=self.slot_of.numel())
        self.held = self.valid.sum(dim=1)  # rows each cell holds

    def verify(self, rows: torch.Tensor, n_rows: int, eps: float) -> dict[str, float]:
        """Checks of the tables against the rows, and the reference's own
        scales (max |projected residual| x float32(1/127), in float64):
          table_rows   rows not in exactly one valid slot, and valid slots
                       in the reserved slabs (empty by definition); exact
          code_steps   over every valid slot, the largest distance in
                       quantization steps between its code and its row's
                       projected residual over the reference's own scale
                       (rounding alone gives 0.5)
          proj_ortho   the largest entry of |P P^T - I| (P: orthonormal
                       rows by definition)
          cell_choice  rows in a k-means cell that is not among their
                       `choices` nearest k-means centroids by more than
                       `eps` (the build places a row in one of them or in
                       a spill slab); exact"""
        count = self.count_of
        if count.numel() < n_rows:
            count = torch.cat([count, count.new_zeros(n_rows - count.numel())])
        bad = int((count[:n_rows] != 1).sum()) + int((count[n_rows:] > 0).sum())
        bad += int(self.valid[self.reserve_start:].sum())
        dev = self.codes.device
        inv127 = float(np.float32(1 / 127))
        self.scales = torch.zeros(self.valid.shape, dtype=torch.float64, device=dev)
        steps = 0.0
        block = max(1, ROW_BLOCK // self.pad // 2)
        for lo in range(0, self.nlist, block):
            c = torch.arange(lo, min(lo + block, self.nlist), device=dev)
            ok = self.valid[c]
            x = rows[self.rowids[c][ok]]
            x = x.double() if self.precision == "full" else int8_rows(x).double()
            cell = c[:, None].expand_as(ok)[ok]
            pr = (x - self.centroids[cell]) @ self.proj.T
            sc = torch.clamp(pr.abs().amax(dim=1), min=1e-9) * inv127
            self.scales[c] = self.scales[c].masked_scatter(ok, sc)
            if pr.numel():
                gap = (self.codes[c][ok].double() - pr / sc[:, None]).abs().amax()
                steps = max(steps, float(gap))
        eye = torch.eye(self.proj.shape[0], dtype=torch.float64, device=dev)
        ortho = float((self.proj @ self.proj.T - eye).abs().amax())
        cell_of = torch.full((n_rows,), -1, dtype=torch.long, device=dev)
        flat = torch.nonzero(self.valid.flatten()).flatten()
        cell_of[self.rowids.flatten()[flat]] = flat // self.pad
        cb = self.centroids[: self.base]
        far = 0
        for lo in range(0, n_rows, ROW_BLOCK // 2):
            s = rows[lo:lo + ROW_BLOCK // 2].double() @ cb.T
            cl = cell_of[lo:lo + ROW_BLOCK // 2]
            in_base = (cl >= 0) & (cl < self.base)
            own = s.gather(1, cl.clamp(0, self.base - 1)[:, None])
            far += int(((s > own + eps).sum(dim=1) >= self.choices)[in_base].sum())
        return {"table_rows": float(bad), "code_steps": steps, "proj_ortho": ortho,
                "cell_choice": float(far)}

    def probes(self, cs: torch.Tensor, eps: float) -> list[list[int]]:
        """The probed cells of one query (centroid scores [nlist]): the top
        nprobe base cells, the lower cell first among equals, then every
        cell past the base ones; and, where the last probed and the first
        unprobed base cell lie within `eps`, the set with those two
        swapped."""
        base = cs[: self.base]
        n = min(self.nprobe, self.base)
        order = torch.sort(base, descending=True, stable=True).indices.tolist()
        rest = list(range(self.base, self.nlist))
        sets = [order[:n] + rest]
        if n < self.base and float(base[order[n - 1]] - base[order[n]]) < eps:
            sets.append(order[:n - 1] + [order[n]] + rest)
        return sets

    def q8(self, q: torch.Tensor, eps: float = 1e-3) -> tuple[list[torch.Tensor], torch.Tensor]:
        """The query's int8 projection and its scale: round half to even
        of the projection over its scale, max|projection| times float32
        1/127 (in float32, as stated). A component whose quotient lies
        within `eps` of a half rounds either way in the system's float32:
        for the two nearest such components the projections with them
        rounded the other way follow the first."""
        qp = q @ self.proj.T
        qs = float(np.float32(max(float(qp.abs().amax()), 1e-9)) * np.float32(1 / 127))
        x = qp / qs
        q8 = torch.round(x)
        alts = [q8]
        near = (x - torch.floor(x) - 0.5).abs()
        for j in torch.argsort(near)[:2].tolist():
            if float(near[j]) < eps:
                other = q8.clone()
                other[j] = torch.floor(x[j]) if float(q8[j]) > float(x[j]) else torch.ceil(x[j])
                alts.append(other)
        return alts, torch.tensor(qs, dtype=torch.float64, device=q.device)

    def scan(self, cells: list[int], q8, qs, cs):
        """(scores [P * pad] float64, row ids, slot validity) of the
        probed cells, in probe order."""
        c = torch.tensor(cells, device=self.codes.device)
        raw = self.codes[c].float() @ q8.float()  # int8 dots: exact in float32
        s = raw.double() * self.scales[c] * qs + cs[c][:, None]
        return s.flatten(), self.rowids[c].flatten(), self.valid[c].flatten()

    def score_of(self, rows: list[int], cells: list[int], q8, qs, cs) -> list[float | None]:
        """The scan's score of each row where its slot lies in a probed cell."""
        out = []
        probed = set(cells)
        for r in rows:
            s = int(self.slot_of[r]) if 0 <= r < self.slot_of.numel() else -1
            if s < 0 or s // self.pad not in probed:
                out.append(None)
                continue
            cell, slot = divmod(s, self.pad)
            raw = float(self.codes[cell, slot].float() @ q8.float())
            out.append(raw * float(self.scales[cell, slot]) * float(qs) + float(cs[cell]))
        return out


class Answer:
    """The reference's reading of one query, beside the system's answer
    to it (``prog``: {"hits": [(row, score)], "arms": [[(row, score)]] x 3,
    "strict": count}): each arm's top list (alternatives of the vector
    arm where a tie within the system's rounding could go either way),
    each arm's value of the rows the system listed (None: dead), the
    rerank score of the system's hits, the strict count, and the final top
    k and fusion pool of each alternative."""

    def __init__(self):
        # per arm, its alternatives: each (top list [(value, row)], the
        # value of each row the system listed, None where dead)
        self.arms: list[list] = []
        self.hit_values: list[float] = []
        self.strict = 0
        self.finals: list[list[tuple[int, float]]] = []
        self.pools: list[set[int]] = []
        self.floor = 0.0
        # the share of the exact vector top k among the rows the system
        # listed (None where no row passes the gate)
        self.recall: float | None = None


def _near_ties(full: list, m: int, eps: float) -> list[list]:
    """`full` cut to m, and each copy with one adjacent pair closer than
    `eps` swapped (the system may order them either way)."""
    alts = [full[:m]]
    for j in range(min(len(full), m + 1) - 1):
        if full[j][0] - full[j + 1][0] < eps:
            swapped = list(full)
            swapped[j], swapped[j + 1] = swapped[j + 1], swapped[j]
            alts.append(swapped[:m])
    return alts


def answer_block(rc: RefCorpus, qs: list[Query], progs: list[dict], cfg: dict,
                 tables: "ProjTables | None", eps: float) -> list[Answer]:
    """The reference's answers for a block of queries and the system's
    answers to them."""
    dev = rc.device
    k = qs[0].k
    m = min(k * env_of(cfg, "MRAG_OVER_FETCH"), rc.n)
    rrf_k = env_of(cfg, "MRAG_RRF_K")
    floor_low = env_of(cfg, "MRAG_CONFIDENCE_LOW", float)
    gate, meta, total = _gate(rc, qs)
    qv = torch.stack([q.vec for q in qs])
    cos_all = rc.cos(qv)
    min_sim = torch.tensor([q.min_sim for q in qs], device=dev, dtype=torch.float64)
    vec_v, vec_i = _top(cos_all, gate & (cos_all >= min_sim[:, None]), m + 1)
    del cos_all
    out = []
    for b, (q, prog) in enumerate(zip(qs, progs)):
        ans = Answer()
        ans.strict = int(total[b])
        exact_k = {r for _, r in _listed(vec_v[b], vec_i[b])[:k]}
        ans.recall = len(exact_k & {r for r, _ in prog["arms"][0]}) / len(exact_k) \
            if exact_k else None
        ans.floor = 0.0 if q.spec["mode"] == "recall" else floor_low
        lex = lexical_scores(rc, q)
        lex_live = (lex > 0) & gate[b]
        lv, li = _top(lex.double()[None], lex_live[None], m)
        dmember = ((rc.d_mask & q.d) != 0) & meta[b]
        dv, di = _top((rc.authority + 1.0).double()[None], dmember[None], m)
        lex_list = _listed(lv[0], li[0])
        dtag_list = _listed(dv[0], di[0])
        vec_rows = [r for r, _ in prog["arms"][0]]
        if tables is None:
            cos = rc.cos(q.vec[None], torch.tensor([vec_rows], device=dev))[0].tolist() \
                if vec_rows else []
            values = [c if bool(gate[b, r]) and c >= q.min_sim else None
                      for r, c in zip(vec_rows, cos)]
            alts = [(alt, values) for alt in _near_ties(_listed(vec_v[b], vec_i[b]), m, eps)]
        else:
            cs = q.vec @ tables.centroids.T
            q8s, qscale = tables.q8(q.vec)
            alts = []
            for cells in tables.probes(cs, eps):
                for q8 in q8s:
                    s, rid, ok = tables.scan(cells, q8, qscale, cs)
                    live = ok & gate[b][rid] & (s >= q.min_sim)
                    sv, si = _top(s[None], live[None], m + 1)
                    values = [v if v is not None and bool(gate[b, vec_rows[n]])
                              and v >= q.min_sim else None for n, v in
                              enumerate(tables.score_of(vec_rows, cells, q8, qscale, cs))]
                    alts += [(alt, values) for alt in _near_ties(
                        [(v, int(rid[i])) for v, i in _listed(sv[0], si[0])], m, eps)]
        lex_rows = [r for r, _ in prog["arms"][1]]
        dtag_rows = [r for r, _ in prog["arms"][2]]
        ans.arms = [alts,
                    [(lex_list, [float(lex[r]) if bool(lex_live[r]) else None
                                 for r in lex_rows])],
                    [(dtag_list, [float(rc.authority[r]) + 1.0 if bool(dmember[r]) else None
                                  for r in dtag_rows])]]
        lex_best = lex_list[0][0] if lex_list else 0.0
        hit_rows = [r for r, _ in prog["hits"]]
        ans.hit_values = rerank(_signals(rc, q, hit_rows, lex, lex_best), q).tolist() \
            if hit_rows else []
        for vec_list, _ in alts:
            final, pool = _fuse(rc, q, [vec_list, lex_list, dtag_list], lex, lex_best,
                                m, rrf_k, k)
            ans.finals.append(final)
            ans.pools.append(pool)
        out.append(ans)
    return out


def _listed(vals: torch.Tensor, ids: torch.Tensor) -> list[tuple[float, int]]:
    """The live (value, id) pairs of a top list."""
    return [(v, i) for v, i in zip(vals.tolist(), ids.tolist()) if v > float("-inf")]


def _signals(rc: RefCorpus, q: Query, rows: list[int], lex, lex_best: float) -> np.ndarray:
    """[len(rows), 5] (sim, auth, len, jpd, cov) per candidate row."""
    dev = rc.device
    idx = torch.tensor(rows, device=dev, dtype=torch.long)
    cos = rc.cos(q.vec[None], idx[None])[0].cpu().numpy()
    lexv = lex[idx].double().cpu().numpy()
    lexn = np.clip(lexv / max(lex_best, 1e-6), 0.0, 1.0)
    sim = np.clip(np.maximum(cos, lexn), 0.0, 1.0)
    auth = rc.authority[idx].double().cpu().numpy()
    dmask = rc.d_mask[idx].cpu().numpy()
    jmask = rc.j_mask[idx].cpu().numpy()
    qd = bin(q.d).count("1")
    jpd = np.array([min(bin(int(x) & q.d).count("1") / max(qd, 1), 1.0) if qd else 0.0
                    for x in dmask])
    feat = rc.feat[idx].cpu().numpy()
    payer = rc.payer_of[idx].cpu().numpy()
    text = rc.text_of[idx].cpu().numpy()
    wsum = sum(w for _, w, _ in q.slots)
    cov = np.zeros(len(rows))
    if wsum > 0:
        for n in range(len(rows)):
            have = rc.phrases_of[(int(payer[n]), int(text[n]))] if feat[n] else set()
            num = 0.0
            for pid, w, jt in q.slots:
                present = pid in have or (jt >= 0 and (int(jmask[n]) >> jt) & 1)
                num += w * float(present)
            cov[n] = num / max(wsum, 1e-6)
    length = rc.length_of[idx].double().cpu().numpy()
    return np.stack([sim, auth, length, jpd, cov], axis=1)


def rerank(sig: np.ndarray, q: Query) -> np.ndarray:
    has_jpd = 1.0 if q.d else 0.0
    has_cov = 1.0 if sum(w for _, w, _ in q.slots) > 0 else 0.0
    w_jpd, w_cov = W_JPD * has_jpd, W_COV * has_cov
    max_w = W_SIM + W_AUTH + W_LEN + w_jpd + w_cov
    return (W_SIM * sig[:, 0] + W_AUTH * sig[:, 1] + W_LEN * sig[:, 2] + w_jpd * sig[:, 3]
            + w_cov * sig[:, 4]) / max(max_w, 1e-6)


def _fuse(rc, q: Query, lists, lex, lex_best: float, m: int, rrf_k: int, k: int):
    """RRF over the arms' lists in arm order (each truncated to m), the
    first occurrence of a row keeping the summed contribution; the top m
    fused candidates (lower list position first among equals) reranked;
    the top k live (row, score)."""
    cands: list[int] = []
    contrib: dict[int, float] = {}
    for a, lst in enumerate(lists):
        for rank, (_, row) in enumerate(lst[:m]):
            c = q.arm_w[a] / (rrf_k + rank + 1.0)
            if row not in contrib:
                cands.append(row)
                contrib[row] = 0.0
            contrib[row] += c
    fused = sorted(range(len(cands)), key=lambda i: (-contrib[cands[i]], i))[:m]
    pool = [cands[i] for i in fused]
    if not pool:
        return [], set()
    score = rerank(_signals(rc, q, pool, lex, lex_best), q)
    order = sorted(range(len(pool)), key=lambda i: (-score[i], i))[:k]
    return [(pool[i], float(score[i])) for i in order], set(pool)
