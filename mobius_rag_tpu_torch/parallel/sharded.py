"""A corpus sharded over a grid of devices, merged on one (the port of
``mobius_rag_tpu.parallel.sharded``).

The chunk matrix and all its companion columns split by row blocks over
the grid's ``shard`` axis: shard s owns global rows [s·Cs, (s+1)·Cs) over a
capacity padded to a multiple of S, so the store's row ids stay valid
global ids. Each shard runs the engine's arm scan on its own device
(``engine.arm_candidates``: arm scores, the local top-m of each arm and
the candidates' rerank signals) and only the small candidate payloads
(M rows × a few floats per arm, never [B, C] scores) travel to the merge
device, the store's own, where ``engine.fuse_and_rerank`` re-sorts each
arm over the shards' lists and fuses. The JAX package runs the same
program under ``shard_map``; its ``psum`` of the strict counts is here a
sum of the shards' counts on the merge device, and its all-gather a
``torch.cat`` of the shards' payloads copied there without blocking.

RRF needs each arm's global ranks: the global top-M of an arm is a
subset of the union of the shards' top-Ms, so gathering them and
re-sorting reproduces the one-device ranks (tests/test_torch_sharded.py
holds the port to its dense engine and to the JAX sharded engine). The
strict count that decides the auto-relax branch is the global one, so
every shard takes the same branch.

A serving grid ([dp, S], ``mesh.make_serve_mesh``) replicates the shards
over its data axis: the batch splits contiguously over the dp groups and
each group scans its own replica; the bucket union of the lexical arm is
global to the batch, so every group gets all of it. Replicas that land on
one device share its tensors.

Live serving: the sharded copy follows the store through its mutation
listeners. Publishes and deletes after construction accumulate as dirty
rows; ``refresh()`` copies those rows into the shards that own them, or
re-shards when the store grew, bulk-loaded, uses the sparse lexical
layout (its per-shard tables are re-keyed) or more than 4,096 rows are
dirty. The query entry points refresh first, so a published document
surfaces without rebuilding the engine.

ANN backends run per shard: each shard clusters its own rows (one nlist
for every shard), the tables are padded to one layout (``pad_shard_*``;
padded zero centroids can take a probe from a real cell that scores
below 0, so the padding is part of the result) and rebuilt whenever the
store's generation moves. Under host residency only pq and proj shard:
the device holds codes, each shard builds from its own rows of the host
matrix, and the exact re-rank runs once, after the merge, from the host.

A batch has a host part and a device program (:meth:`ShardedEngine.plan`).
The host part refreshes the shards, builds the ANN tables and works out
the widths; it never runs inside a capture. The device program is a
function of the prepared batch alone, bound to the shard tables as they
stood when the batch was planned. On a grid whose devices are all the
merge device (:func:`on_one_device`: a card named S times), the program
is the JAX ``run``'s counterpart as one CUDA graph per key, kept by the
sharded engine's own :class:`~mobius_rag_tpu_torch.query.compiled.CapturedPrograms`
(``SearchEngine`` replays it; see ``query/compiled.py``). On a grid over
several devices it runs as three stages, split where the program crosses
devices, each one graph per device (a ``ProgramsByDevice``: a pool and a
capture stream belong to one device): every device computes its shards'
strict counts; every device sums all S counts (the JAX ``psum``: exact,
the counts are integers below 2^24) and scans its shards' arms; the merge
device sums them too and merges and reranks. Between stages, outside any
graph, each stage's outputs leave its pool right behind its replay and
are copied into the next stage's static inputs on the devices that read
them, each copy behind a CUDA event of the source's stream
(``compiled.join``). A copy between cards runs on its source's stream, so
every card's copies of the counts are enqueued before any card's arm
scan: behind a scan, a copy would hold the next card's scan until the
first ended. The stages run the whole program's operations on
the same values, so they give its outputs bitwise; the launches of the
kernels they count add up to the whole program's.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.index.ivf import IVFIndex, PackedIVF, pad_shard_ivf, pad_shard_packed
from mobius_rag_tpu_torch.index.store import ChunkStore, DeviceIndex
from mobius_rag_tpu_torch.ops.pq import PackedPQ, effective_m, pad_shard_pq
from mobius_rag_tpu_torch.ops.proj import PackedProj, pad_shard_proj
from mobius_rag_tpu_torch.parallel.mesh import Mesh, make_mesh, make_serve_mesh
from mobius_rag_tpu_torch.query import engine as eng
from mobius_rag_tpu_torch.query import gating
from mobius_rag_tpu_torch.query.compiled import (CapturedPrograms, ProgramsByDevice, join,
                                                 tables_held)
from mobius_rag_tpu_torch.utils import round_up

# More dirty rows than this re-shard the index instead of copying rows.
_REBUILD_ROWS = 4096

_PAD_SHARDS = {"ivf": pad_shard_ivf, "packed": pad_shard_packed, "pq": pad_shard_pq,
               "proj": pad_shard_proj}


def _tables_to(tables, device: torch.device):
    """ANN tables (any class) with their tensors on `device`."""
    if tables.centroids.device == device:
        return tables
    out = copy.copy(tables)
    for f in type(tables).FIELDS:
        setattr(out, f, getattr(tables, f).to(device))
    return out


def on_one_device(groups: list[list[torch.device]], device: torch.device) -> bool:
    """Whether every device of the grid (``mesh.groups(axis)``) is `device`,
    the merge device: then the whole sharded program runs on it and is
    captured as one CUDA graph. A capture records only the capturing
    device's stream, so a grid over several devices is captured as stages,
    one graph per device and stage (:meth:`ShardedEngine.plan`)."""
    return all(dev == device for row in groups for dev in row)


def _to(q: dict, device: torch.device) -> dict:
    """A prepared batch on `device`, copied without blocking."""
    return {key: v.to(device, non_blocking=True) for key, v in q.items()}


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: itself, or a copy joined there (``compiled.join``)."""
    if t.device == device:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    join(out, t)
    return out


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Tensors of one type as one flat tensor, in order (a stage's outputs
    leave its pool as one copy)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, shapes: list[tuple]) -> list[torch.Tensor]:
    """Views of `flat` in `shapes`, in order (:func:`_flat`'s inverse)."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


@dataclasses.dataclass
class Plan:
    """One batch's device side (:meth:`ShardedEngine.plan`): its key, every
    tensor of the tables it reads, the program whole (a function of the
    prepared batch on the merge device: eager, or captured as one graph
    where the grid is one device) and ``staged(programs, host, prep,
    finish)``, the same program as one graph per device and stage over a
    :class:`~mobius_rag_tpu_torch.query.compiled.ProgramsByDevice`."""
    key: tuple
    held: list
    program: Callable[[dict], dict]
    staged: Callable


class ShardedEngine:
    """Search over a corpus sharded across a device grid.

    Built from a ChunkStore: rows are block-partitioned over the shards
    (shard s owns global rows [s·Cs, (s+1)·Cs)), so the store's row ids
    remain valid for record lookup. ``mesh`` is a ``parallel.mesh.Mesh``;
    by default ``MRAG_NUM_SHARDS`` shards over the visible CUDA devices
    (``MRAG_SERVE_DP`` > 1: a [dp, shards] grid)."""

    def __init__(self, store: ChunkStore, mesh: Mesh | None = None,
                 cfg: Config | None = None, axis: str | None = None,
                 vector_backend: str | None = None):
        self.cfg = cfg or get_config()
        self.store = store
        backend = vector_backend or self.cfg.vector_backend
        eng._check_backend(backend)
        if store.host_vectors is not None and backend not in ("pq", "proj"):
            raise ValueError(
                "host vector residency shards as a codes-only index: the device "
                "holds per-shard pq or proj tables and the exact re-rank runs "
                "from host RAM after the merge, so the vector backend must be "
                "'pq' or 'proj' (exact, ivf and packed need the rows on the device)")
        self.axis = axis or self.cfg.shard_axis
        if mesh is None:
            mesh = (make_serve_mesh(self.cfg.serve_dp, self.cfg.num_shards,
                                    shard_axis=self.axis)
                    if self.cfg.serve_dp > 1 else make_mesh(self.cfg.num_shards, self.axis))
        self.mesh = mesh
        # [dp][S] devices: one row per data group
        self.groups = mesh.groups(self.axis)
        self.num_shards = len(self.groups[0])
        # the merge device: the store's, where prepared batches arrive
        self.device = store.index.valid.device
        self.one_device = on_one_device(self.groups, self.device)
        # the captured programs (query/compiled.py), made at first use
        self._programs: CapturedPrograms | None = None
        self.vector_backend = backend
        self._pending: set[int] = set()
        self._needs_rebuild = False
        # the store's events, refresh() and a batch's host part come from any
        # thread (the API publishes on its handlers' threads while a batcher
        # searches)
        self._lock = threading.RLock()
        self._sparse = "lex_cols" in store.index.fields
        store.listeners.append(self._on_store_event)
        self._shard_index()
        self._synced_generation = store.generation
        # per-shard ANN tables ([dp][S], replicas sharing a device shared),
        # rebuilt whenever the store's generation moves
        self._ann = None
        self._ann_generation = -1
        self._ann_backend = None

    # -- liveness ----------------------------------------------------------

    def _on_store_event(self, event: str, rows: list[int]) -> None:
        with self._lock:
            if event in ("grow", "bulk") or self._sparse:
                # a new capacity or a bulk rewrite reshapes the shards; the
                # sparse tables are re-keyed per shard
                self._needs_rebuild = True
            else:
                self._pending.update(rows)

    @property
    def stale(self) -> bool:
        # the store bumps its generation before it reports the rows, so an
        # event that arrives after a refresh read the generation still counts
        return (self._synced_generation != self.store.generation or self._needs_rebuild
                or bool(self._pending))

    def refresh(self) -> dict:
        """Bring the sharded copy up to date with the store: the dirty rows
        copied into the shards that own them, or a re-shard (see the module
        docstring). Returns {"refreshed": False} when already current, else
        {"refreshed": True, "mode": "scatter:<rows>" or "rebuild"}. Safe to
        call from any thread, while the store takes writes."""
        with self._lock:
            if not self.stale:
                return {"refreshed": False}
            generation = self.store.generation
            if self._needs_rebuild or len(self._pending) > _REBUILD_ROWS:
                self._shard_index()
                mode = "rebuild"
            else:
                self._apply_rows(sorted(self._pending))
                mode = f"scatter:{len(self._pending)}"
            self._pending.clear()
            self._needs_rebuild = False
            self._synced_generation = generation
            return {"refreshed": True, "mode": mode}

    def _apply_rows(self, rows: list[int]) -> None:
        """Copy the store's current values of `rows` into each shard copy
        that owns them (every field but the sparse tables and an empty
        host-residency payload)."""
        if not rows:
            return
        src = self.store.index
        cs = self.c_local
        rows_np = np.asarray(rows, np.int64)
        for (dev, s), idx in self._copies.items():
            mine = rows_np[(rows_np >= s * cs) & (rows_np < (s + 1) * cs)]
            if not len(mine):
                continue
            g = torch.from_numpy(mine).to(self.device)
            local = torch.from_numpy(mine - s * cs).to(dev)
            for f in src.fields:
                if f in ("lex_cols", "lex_wts"):
                    continue
                dst = getattr(idx, f)
                if f == "lexical":  # bucket-major [H, C]: columns
                    dst[:, local] = src.lexical[:, g].to(dev)
                elif dst.shape[0]:
                    dst[local] = getattr(src, f)[g].to(dev)

    def rebuilt(self, store: ChunkStore) -> "ShardedEngine":
        """A fresh sharded engine over a new store (the swap after a
        restore), on this engine's grid and backend."""
        return ShardedEngine(store, mesh=self.mesh, cfg=self.cfg, axis=self.axis,
                             vector_backend=self.vector_backend)

    def captured_programs(self) -> CapturedPrograms | ProgramsByDevice:
        """This engine's captured programs, made at first use (a dense
        engine's graphs key on other tables): on a grid whose devices are
        all the merge device one ``CapturedPrograms``, one graph a key;
        on a grid over several devices a ``ProgramsByDevice`` over the
        merge device and every device of the grid, one graph per device
        and stage (a capture records only its own device's stream).
        Raises ValueError off a card."""
        if self._programs is None:
            if self.one_device:
                self._programs = CapturedPrograms(self.device)  # raises off a card
            else:
                self._programs = ProgramsByDevice(
                    [self.device] + [dev for row in self.groups for dev in row])
        return self._programs

    # -- build ---------------------------------------------------------------

    def _shard_index(self) -> None:
        """(Re)build every shard copy from the store: row block s of every
        field (the columns of the dense lexical matrix), zero-padded to the
        padded capacity, on each device of shard s's column of the grid."""
        index = self.store.index
        s = self.num_shards
        c_pad = round_up(index.capacity, s)
        cs = c_pad // s
        sparse = self._shard_sparse_tables(cs) if "lex_cols" in index.fields else None
        copies: dict[tuple[torch.device, int], DeviceIndex] = {}
        for row in self.groups:
            for si, dev in enumerate(row):
                if (dev, si) not in copies:
                    copies[(dev, si)] = self._one_shard(index, si, dev, cs, sparse)
        shards = [[copies[(dev, si)] for si, dev in enumerate(row)] for row in self.groups]
        # new containers, never mutated: a batch planned before keeps its own
        self.c_pad, self.c_local, self._copies, self.shards = c_pad, cs, copies, shards

    def _one_shard(self, index: DeviceIndex, si: int, dev: torch.device, cs: int,
                   sparse) -> DeviceIndex:
        arrays = {}
        for f in index.fields:
            if f in ("lex_cols", "lex_wts"):
                continue
            a = getattr(index, f)
            axis = 1 if f == "lexical" else 0  # the chunk axis
            c = a.shape[axis]
            if c == 0:
                # host residency: the device payload is [0, D]; it stays empty
                arrays[f] = a.to(dev, copy=True)
                continue
            part = a.narrow(axis, min(si * cs, c), max(0, min(cs, c - si * cs)))
            if part.shape[axis] < cs:
                shape = list(a.shape)
                shape[axis] = cs - part.shape[axis]
                part = torch.cat([part, a.new_zeros(shape)], dim=axis)
            arrays[f] = part.to(dev, copy=True)
        if sparse is not None:
            cols, wts = sparse
            arrays["lex_cols"] = torch.from_numpy(cols[si]).to(dev)
            arrays["lex_wts"] = torch.from_numpy(wts[si]).to(dev).to(torch.bfloat16)
        return DeviceIndex(**arrays)

    def _shard_sparse_tables(self, cs: int) -> tuple[np.ndarray, np.ndarray]:
        """The store's sparse postings re-keyed per shard of `cs` rows: shard
        s's table holds its own rows' postings under local row ids, so its
        lexical arm adds into [B, Cs] directly. Returns (cols [S, H, P]
        int32, wts [S, H, P] float32), P the largest shard-bucket fill
        rounded up to 8, every shard's postings in the store's order."""
        s = self.num_shards
        cols_np = self.store._lex_cols_np  # [H, P] global row ids
        wts_np = self.store._lex_wts_np
        h = cols_np.shape[0]
        hh, pp = np.nonzero(cols_np >= 0)
        rows = cols_np[hh, pp]
        shard = rows // cs
        key = shard * h + hh  # row of the stacked [S·H, P] tables
        counts = np.bincount(key, minlength=s * h)
        p_loc = int(round_up(max(8, int(counts.max(initial=0))), 8))
        out_cols = np.full((s * h, p_loc), -1, np.int32)
        out_wts = np.zeros((s * h, p_loc), np.float32)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        slot = np.arange(len(ks)) - np.searchsorted(ks, ks, side="left")
        out_cols[ks, slot] = (rows - shard * cs)[order]
        out_wts[ks, slot] = wts_np[hh, pp][order]
        return out_cols.reshape(s, h, p_loc), out_wts.reshape(s, h, p_loc)

    # -- vector-arm ANN backend ---------------------------------------------

    def set_vector_backend(self, backend: str) -> None:
        eng._check_backend(backend)
        if self.store.host_vectors is not None and backend not in ("pq", "proj"):
            raise ValueError("host vector residency serves codes-only shards: the "
                             "backend must stay 'pq' or 'proj'")
        self.vector_backend = backend

    def ensure_ann(self):
        """Per-shard ANN tables of the configured backend ([dp][S], each on
        its shard's device; None for exact). Shard s clusters the store's
        rows [s·Cs, (s+1)·Cs) with local row ids (the arm scan adds the
        shard's offset), every shard at nlist = MRAG_IVF_NLIST or
        max(16, isqrt(live rows / S)); the tables are then padded to one
        layout. Built on the store's device, from the host matrix under
        host residency."""
        if self.vector_backend == "exact":
            return None
        if (self._ann is not None and self._ann_generation == self.store.generation
                and self._ann_backend == self.vector_backend):
            return self._ann
        cfg, store = self.cfg, self.store
        src = store.index
        s, cs = self.num_shards, self.c_local
        valid = src.valid.cpu().numpy()
        n_live = int((valid > 0).sum())
        nlist = cfg.ivf_nlist or max(16, int(np.sqrt(max(n_live // s, 1))))
        pq_m = effective_m(cfg.embed_dim, cfg.pq_m)
        int8 = cfg.vector_dtype == "int8"
        shards = []
        for si in range(s):
            lo, hi = si * cs, min((si + 1) * cs, src.capacity)
            if store.host_vectors is not None:
                hv, hs = store.host_vectors[lo:hi], store.host_scales[lo:hi]
                ivf = IVFIndex.build_host(hv, hs, valid[lo:hi], device=self.device,
                                          nlist=nlist)
                if self.vector_backend == "proj":
                    shards.append(PackedProj.from_ivf(ivf, hv, p=cfg.proj_p, row_scales=hs))
                else:
                    shards.append(PackedPQ.from_ivf(ivf, hv, m=pq_m, row_scales=hs))
                continue
            vec = src.vectors[lo:hi]
            ivf = IVFIndex.build(vec, valid[lo:hi], nlist=nlist)
            scales = src.vec_scales[lo:hi] if int8 else None
            if self.vector_backend == "packed":
                shards.append(PackedIVF.from_ivf(ivf, vec, row_scales=scales))
            elif self.vector_backend == "pq":
                shards.append(PackedPQ.from_ivf(ivf, vec, m=pq_m, row_scales=scales))
            elif self.vector_backend == "proj":
                shards.append(PackedProj.from_ivf(ivf, vec, p=cfg.proj_p, row_scales=scales))
            else:
                shards.append(ivf)
        padded = _PAD_SHARDS[self.vector_backend](shards)
        copies: dict[tuple[torch.device, int], object] = {}
        self._ann = [[copies.setdefault((dev, si), _tables_to(padded[si], dev))
                      for si, dev in enumerate(row)] for row in self.groups]
        self._ann_generation = store.generation
        self._ann_backend = self.vector_backend
        return self._ann

    # -- query ---------------------------------------------------------------

    def plan(self, b: int, k: int, funnel: int = 0) -> Plan:
        """The host part of a batch of `b` queries: refresh the shards, the
        ANN tables, the per-shard widths. Returns its :class:`Plan`: the
        device program of the batch, whole (:meth:`run`'s) and as stages,
        each a function of the prepared batch alone, bound to the shard and
        ANN tables as they stand now (a refresh or rebuild on another
        thread reaches the next batch); its key (the JAX ``run``'s static
        arguments as passed: k, funnel, over_fetch, rrf_k, nprobe, approx,
        the ANN tables' class; and the grid's shape) and every tensor of the
        tables it reads."""
        with self._lock:  # one layout: a refresh on another thread waits for it
            self.refresh()
            ann = self.ensure_ann()
            shards, c_total, c_local = self.shards, self.c_pad, self.c_local
        cfg, groups, s = self.cfg, self.groups, self.num_shards
        w = min(funnel, c_total)
        # Per-shard widths: an arm's global top pool (and the global funnel
        # top-w) may lie entirely on one shard. Under a funnel (host
        # residency) `k` arrives already over-fetched, so the pool is k.
        pool = k if funnel else k * cfg.over_fetch
        m = min(max(pool, w), c_local)
        m_other = min(pool, c_local)
        m_global = min(pool, c_total)
        b_loc = -(-b // len(groups))
        nprobe, approx, rrf_k = cfg.ivf_nprobe, cfg.ann_approx_topk, cfg.rrf_k
        key = (k, funnel, cfg.over_fetch, rrf_k, nprobe, approx,
               None if ann is None else type(ann[0][0]).__name__, len(groups), s)
        tables: dict = {}  # (device, shard) -> (its index copy, its ANN tables)
        for g, row in enumerate(groups):
            for si, dev in enumerate(row):
                tables.setdefault((dev, si), (shards[g][si], None if ann is None else ann[g][si]))
        held_on: dict[torch.device, list[torch.Tensor]] = {}
        for (dev, _), (idx, a) in tables.items():
            held_on.setdefault(dev, []).extend(tables_held(idx, a))
        dev0 = self.device
        # the groups that get rows (a batch smaller than dp leaves some
        # empty) and, per device, the (group, shard) positions it scans
        live = [g for g in range(len(groups)) if g * b_loc < b]
        at: dict[torch.device, list[tuple[int, int]]] = {}
        for g in live:
            for si, dev in enumerate(groups[g]):
                at.setdefault(dev, []).append((g, si))

        def rows(g: int) -> slice:
            return slice(g * b_loc, min((g + 1) * b_loc, b))

        def group(q: dict, g: int) -> dict:
            return {key: (v if key == "lex_buckets" else v[rows(g)]) for key, v in q.items()}

        def arms(g: int, si: int, qd: dict, total):
            return eng.arm_candidates(
                shards[g][si], qd, k, m, m_other=m_other, ann=None if ann is None else ann[g][si],
                nprobe=nprobe, approx=approx, strict_total=total, offset=si * c_local)

        def merged(q: dict, parts: list, totals: list) -> dict[str, torch.Tensor]:
            # each arm re-sorted once over the shards' lists, as wide as
            # fusion, the traces and the funnel read
            vals, gidx, sigs = eng.merge_shard_lists(
                *(torch.cat([p[i] for p in parts], dim=2) for i in range(3)),
                min(max(m_global, 2 * k, w), s * m))
            out = eng.fuse_and_rerank(vals, gidx, sigs, q, k, rrf_k, m_global)
            for a, name in enumerate(("vec", "lex", "dtag")):
                out[f"{name}_idx"], out[f"{name}_vals"] = gidx[a][:, :2 * k], vals[a][:, :2 * k]
            out["strict_count"] = torch.cat(totals)[:, 0]
            if w:
                out.update(eng.wide_outputs(vals, gidx, sigs, w))
            return out

        @torch.inference_mode()
        def program(q: dict) -> dict[str, torch.Tensor]:
            q = dict(q, vec=q["vec"].float())  # bf16-rounded queries, widened once
            parts, totals = [], []
            for g in live:
                row, qg = groups[g], group(q, g)
                on: dict[torch.device, dict] = {}
                qs = [on.setdefault(dev, qg if dev == dev0 else _to(qg, dev)) for dev in row]
                # the global strict count, the shards' counts summed on the
                # merge device; one shard's own count is already the global one
                total = None if s == 1 else sum(
                    gating.strict_counts(idx, qd).to(dev0, non_blocking=True)
                    for idx, qd in zip(shards[g], qs))[:, None]
                out = [arms(g, si, qd, None if total is None
                            else total.to(dev, non_blocking=True))
                       for si, (qd, dev) in enumerate(zip(qs, row))]
                totals.append(out[0][3].to(dev0, non_blocking=True) if total is None
                              else total)
                parts.append([torch.stack([o[i].to(dev0, non_blocking=True) for o in out],
                                          dim=1) for i in range(3)])  # [3, S, B_g, m(, N_SIG)]
            return merged(q, parts, totals)

        # -- the same program as stages, one graph per device and stage ----
        devs = list(at)
        shapes = {g: (rows(g).stop - rows(g).start, m) for g in live}

        def float_shapes(g: int) -> list[tuple]:
            """A shard's float outputs as an arm stage flattens them: vals,
            sigs and, at S = 1, its own strict count."""
            bg, mg = shapes[g]
            return [(3, bg, mg), (3, bg, mg, eng.N_SIG)] + ([(bg, 1)] if s == 1 else [])

        def counted(static: dict) -> torch.Tensor:
            """[S, B] float32: every shard's strict counts over its group's
            rows, summed over the devices' count stages (each writes only
            its own shards' entries: the sum adds zeros, and every count is
            an integer below 2^24, so any order is exact)."""
            return sum(static[f"count{j}"] for j in range(len(devs)))

        def count_stage(dev: torch.device, batch):
            @torch.inference_mode()
            def stage(static: dict) -> torch.Tensor:
                q = batch(static)
                cnt = torch.zeros((s, b), dtype=torch.float32, device=dev)
                for g, si in at[dev]:
                    cnt[si, rows(g)] = gating.strict_counts(shards[g][si], group(q, g))
                return cnt
            return stage

        def arms_stage(dev: torch.device, batch):
            @torch.inference_mode()
            def stage(static: dict) -> tuple[torch.Tensor, torch.Tensor]:
                q = batch(static)
                total = None if s == 1 else sum(counted(static))  # [B]: the psum
                floats, ints = [], []
                for g, si in at[dev]:
                    vals, gidx, sigs, strict = arms(
                        g, si, group(q, g), None if total is None else total[rows(g), None])
                    floats += [vals, sigs] + ([strict] if s == 1 else [])
                    ints.append(gidx)
                return _flat(floats), _flat(ints)
            return stage

        def merge_stage(batch, finish):
            @torch.inference_mode()
            def stage(static: dict):
                q = batch(static)
                lists = {}  # (group, shard) -> (vals, gidx, sigs, strict or None)
                for j, dev in enumerate(devs):
                    fl = iter(_unflat(static[f"floats{j}"],
                                      [sh for g, _ in at[dev] for sh in float_shapes(g)]))
                    il = iter(_unflat(static[f"ints{j}"], [(3, *shapes[g]) for g, _ in at[dev]]))
                    for g, si in at[dev]:
                        vals, sigs = next(fl), next(fl)
                        lists[g, si] = (vals, next(il), sigs, next(fl) if s == 1 else None)
                parts, totals = [], []
                total = None if s == 1 else sum(counted(static))
                for g in live:
                    parts.append([torch.stack([lists[g, si][i] for si in range(s)], dim=1)
                                  for i in range(3)])
                    totals.append(lists[g, 0][3] if total is None else total[rows(g), None])
                return finish(merged(q, parts, totals))
            return stage

        def staged(programs: ProgramsByDevice, host: dict, prep, finish):
            """The program as stages over `programs` (one CapturedPrograms
            per device), on the host arrays `host`: each device's count
            stage (S > 1), each device's arm stage, the merge stage on the
            merge device. `prep` takes a stage's uploaded batch to the
            program's input (the engine's bf16 rounding of the queries),
            `finish` the merged outputs to what the merge stage returns.
            Every stage's outputs are copied out of its pool right behind
            its replay; the caller holds ``compiled.LOCK``."""
            def batch(static: dict) -> dict:  # the host arrays' views, as `program` gets q
                q = prep({name: static[name] for name in host})
                return dict(q, vec=q["vec"].float())

            counts: dict[str, torch.Tensor] = {}
            if s > 1:
                for j, dev in enumerate(devs):
                    counts[f"count{j}"] = programs[dev].run(
                        ("count", *key), held_on[dev], host, count_stage(dev, batch)).clone()
            # every device's copy of the counts is enqueued before any arm
            # scan: a copy between cards runs on its source's stream, where
            # one queued behind that card's scan would hold the next card's
            # scan until it ended (the cards would scan one after another)
            here = {dev: {name: _moved(t, dev) for name, t in counts.items()} for dev in devs}
            lists: dict[str, torch.Tensor] = {}
            for j, dev in enumerate(devs):
                fl, il = programs[dev].run(("arms", *key), held_on[dev], host,
                                           arms_stage(dev, batch), here[dev])
                lists[f"floats{j}"], lists[f"ints{j}"] = fl.clone(), il.clone()
            return programs[dev0].run(("merge", *key), held_on.get(dev0, []), host,
                                      merge_stage(batch, finish), {**counts, **lists})

        return Plan(key, [t for ts in held_on.values() for t in ts], program, staged)

    def run(self, q: dict, k: int, funnel: int = 0) -> dict[str, torch.Tensor]:
        """The sharded device program for one prepared batch (tensors on the
        merge device, as ``SearchEngine.prepare_batch`` returns them):
        per-shard arm scans, the merge and the rerank, enqueued without a
        host wait, eagerly. Returns ``engine.search_batch``'s schema on the
        merge device: the fused top k, each arm's merged top 2k, the global
        strict counts and, when ``funnel`` > 0, the funnel block."""
        return self.plan(q["vec"].shape[0], k, funnel).program(q)

    def search_arrays(self, q: dict, k: int) -> dict[str, np.ndarray]:
        """The sharded program on a prepared batch (``SearchEngine.
        prepare_batch``'s tensors), its outputs on the host (see
        :meth:`run`)."""
        return {key: v.cpu().numpy() for key, v in self.run(q, k).items()}

    def search(self, engine, reqs, k: int | None = None):
        """A full search over the sharded index: `engine`, a SearchEngine
        over the same store, serves it with this grid attached (its host
        preparation, the exact host re-rank under host residency and the
        assembly; the device program runs sharded)."""
        if engine.sharded is not self:
            engine = copy.copy(engine)
            engine.sharded, engine.vector_backend = self, self.vector_backend
        return engine.search(reqs, k or self.cfg.default_k)
