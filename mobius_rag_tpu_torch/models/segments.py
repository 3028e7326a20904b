"""The training step over a grid whose positions span several devices, as
segment graphs: the port of the JAX ``train_step`` over a ("dp", "tp")
mesh of several devices (``mobius_rag_tpu/models/train.py``,
``make_train_step``: one XLA program, ``params`` and ``opt_state``
donated).

A CUDA graph records one device's stream, so only a grid whose positions
are all one device captures the step whole (``models/train.py``). Over
several devices the step crosses between grid positions inside every
layer: a dp row's tensor-parallel shards send their attention and MLP
partials to the row's first position (the psum over tp), which sends the
normed stream back (``models/encoder.GridEncoder``); the column-split
tables meet there; the rows' embeddings meet on the grid's first position
for the loss; the backward runs every edge the other way. The step is cut
at those edges into segments, each a maximal run of one row's forward of
one tower (queries, then documents) on one grid position, in the eager
forward's order:

- the embedding, the first norm and shard 0's attention on the row's
  first position (shard 0 lies there);
- each other shard's attention on its own position;
- the psum, the residual, the next norm and shard 0's MLP on the first;
- each other shard's MLP;
- the psum, the residual, the next norm and shard 0's next attention, or
  after the last layer the final norm, the pooling and the projection.

At tp = 1 a row's whole forward is one segment. The loss on the grid's
first position is one more. The pieces are ``encoder.row_pieces``, the
forward that ``GridEncoder`` runs eagerly. The cut is at grid positions,
not devices: a grid of one card named dp x tp times runs the same
segments, its edges copies on that card (``chip_smoke._forced_stages``
forces the route so).

Each segment has two graphs: its forward, recorded with autograd on (its
saved tensors live in the graphs' pool), and its backward, the
vector-Jacobian product of its outputs with respect to its inputs and the
parameters it reads (``torch.cuda.make_graphed_callables``' pattern, under
this package's capture rules: ``compiled.CapturedPrograms._capture``).
Then the tail, one graph per position and stage: each position's
gradients summed over the two towers (written flat for the dp sum); on
row 0's positions the dp sum in row order, the zero fill, the squared
sums; on the grid's first position the global norm, the clip and its
owners' AdamW; on the other row-0 positions their clip and AdamW. The
host stitches the graphs: it uploads the token blocks, replays, and
between replays copies each edge's tensor into the next graph's static
input (``compiled.join``: behind a CUDA event between cards), one copy per
edge and position; after the tail it copies the owners into every other
position's parameters (``GridModel.copy_from_owners``).

A key is the block's (B, Lq, Ld) with (dp, tp), the one graph's: each
token block trims once to its sequence bucket, then splits over dp, as the
eager ``shard_batch`` does, so every part of a block runs at the block's
width. A row's tower reads only its own part, so its graphs are captured
once per (B, tower, row, width) and shared by every key that has that
width: at most the bucket ladder's length per row and tower. The loss is
captured once per B; the tail,
which reads the rows' gradients where their graphs left them, once per key
(a few graphs and little memory; past MAX_KEYS keys the least recently
used one's goes, with the rows' and losses' captures no kept key uses).
Each row's tower and each loss has a pool of its own on each device
(``ProgramsByDevice.pool``): a step replays other rows' graphs between a
segment's forward and its backward, and in a shared pool a graph captured
later could be given memory that those hold. The tails share a pool per
device (one key's tail runs a step). Within a pool the graphs are captured
in the order they replay, so that a graph reuses only pool memory the
graphs before it had freed. Every graph of a device is captured on that
device's one capture stream: a tower's forward graphs keep the
AccumulateGrad nodes of the parameters they read alive until their
backward is captured, and the other tower reads the same parameters. The
first step of a key runs eagerly (its result), then
the captures it lacks, which run nothing. A failed capture raises, drops
what it made and leaves nothing to fall back on.

The numbers are the eager grid step's, bitwise on one device: every sum
across a cut is taken in eager autograd's order. The normed stream's
gradient fans in from the tp shards: the engine runs the ready node
created last first, so eager sums the shards' gradients from the last
shard down, ((g[tp-1] + g[tp-2]) + ...) + g[0]; the segment that made the
stream sums its other shards' so and autograd adds shard 0's inside.
Every parameter's two towers and the stream's two uses each add two terms
(float addition commutes). The dp sum runs in row order and the clip's
norm over the owners' squared sums in parameter order, as the eager step.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from mobius_rag_tpu_torch.models.encoder import Piece, row_pieces, seq_bucket
from mobius_rag_tpu_torch.query.compiled import (LOCK, ProgramsByDevice, identity, join,
                                                 to_device)

TOWERS = ("q", "d")
# keys (their tails) kept per trainer; the rows' captures are bounded by the
# bucket ladder, not by this
MAX_KEYS = 64


@dataclasses.dataclass(eq=False)
class Segment:
    """A maximal run of pieces on one grid position (the loss is one too),
    and, once a key is captured, its static tensors and graphs."""
    name: tuple  # (tower, row, index) or ("loss",)
    pos: tuple
    pieces: list
    reads: list  # names read from outside the segment, in order
    outputs: list = dataclasses.field(default_factory=list)  # read by later segments
    inputs: dict = dataclasses.field(default_factory=dict)  # name -> static input
    live: dict = dataclasses.field(default_factory=dict)  # outputs, with autograd
    contribs: dict = dataclasses.field(default_factory=dict)  # output -> gradients
    joins: list = dataclasses.field(default_factory=list)  # before its backward

    def forward(self) -> dict:
        env = dict(self.inputs)
        with torch.enable_grad():
            for piece in self.pieces:
                piece.fn(env)
        self.live = {o: env[o] for o in self.outputs}
        return self.live

    def differentiable(self) -> list:
        return [n for n, t in self.inputs.items() if t.requires_grad]

    def backward(self) -> tuple:
        """The gradients of the differentiable inputs (None where unused).
        An output's gradients from later segments arrive in the reverse of
        their creation and are summed in that order."""
        outs, gouts = [], []
        for name, grads in self.contribs.items():
            g = grads[0]
            for more in grads[1:]:
                g = g + more
            outs.append(self.live[name])
            gouts.append(g)
        if self.name == ("loss",):
            outs, gouts = [self.live[("loss",)]], None
        return torch.autograd.grad(outs, [self.inputs[n] for n in self.differentiable()],
                                   gouts, allow_unused=True)


def _group(pieces: list[Piece], name: Callable[[int], tuple]) -> list[Segment]:
    """Consecutive pieces on one position as one segment each; a segment
    reads what its pieces read that none of them wrote before."""
    segs: list[Segment] = []
    for piece in pieces:
        if segs and segs[-1].pos == piece.pos:
            segs[-1].pieces.append(piece)
        else:
            segs.append(Segment(name(len(segs)), piece.pos, [piece], []))
    for seg in segs:
        written: set = set()
        for piece in seg.pieces:
            seg.reads += [n for n in piece.reads if n not in written and n not in seg.reads]
            written.update(piece.writes)
    return segs


def row_segments(cfg, tower: str, i: int, tp: int) -> list[Segment]:
    """Row i's forward of one tower (``encoder.row_pieces``) as segments in
    order. A segment's outputs are the names later segments read (the last
    one's: the row's embedding, which the loss reads)."""
    segs = _group(row_pieces(cfg, tower, i, tp), lambda k: (tower, i, k))
    later = {(tower, i, "out")}
    for seg in reversed(segs):
        seg.outputs = [n for p in seg.pieces for n in p.writes if n in later]
        later.update(seg.reads)
    return segs


def loss_segment(dp: int, temperature: float) -> Segment:
    """The loss on the grid's first position: ``train.infonce`` on the
    rows' embeddings concatenated in row order, as ``GridModel.__call__``."""
    from mobius_rag_tpu_torch.models.train import infonce

    def loss(env):
        qe, de = (torch.cat([env[(t, i, "out")] for i in range(dp)]) for t in TOWERS)
        env[("loss",)], env[("accuracy",)] = infonce(qe, de, temperature)

    reads = tuple((t, i, "out") for t in TOWERS for i in range(dp))
    metrics = (("loss",), ("accuracy",))
    return Segment(("loss",), (0, 0), [Piece((0, 0), reads, metrics, loss)], list(reads),
                   list(metrics))


def tail_graphs(dp: int, tp: int) -> int:
    """The tail's graphs a key: one per position of rows 1.. (its towers'
    sum), one per other row-0 position (its dp sum and squared sums), the
    grid's first position's (its dp sum, the norm, its clip and AdamW),
    one more per other row-0 position (its clip and AdamW)."""
    return (dp - 1) * tp + 2 * (tp - 1) + 1


def graphs_per_key(cfg, dp: int, tp: int) -> dict:
    """The graphs one step replays: forward segments (every row's of both
    towers, and the loss), as many backwards, the tail; and those of one
    row's tower at one width (``row``: what a new width captures)."""
    n = len(row_segments(cfg, TOWERS[0], 0, tp))
    forward = 2 * dp * n + 1
    return {"forward": forward, "backward": forward, "tail": tail_graphs(dp, tp),
            "graphs": 2 * forward + tail_graphs(dp, tp), "row": 2 * n}


def _paths(tree, path=()):
    """(path, leaf) of a parameter tree in ``tree_map`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for k, v in enumerate(tree):
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _sub_optimizer(opt: torch.optim.Optimizer, params: list) -> torch.optim.Optimizer:
    """``opt`` over `params` only, sharing its settings and its state (a
    step of it is ``opt.step()``'s update of those parameters: AdamW is
    elementwise)."""
    sub = copy.copy(opt)
    sub.param_groups = [dict(opt.param_groups[0], params=list(params))]
    return sub


class _Trained:
    """What the route keeps for one model and optimizer, across keys: the
    parameters by name, the owners' gradient buffers (their ``.grad``),
    one optimizer per row-0 position over its owners, the tail's flat
    buffers, and the copies every key shares (the parameters' copies on
    the positions that read them, and the joins that fill them: a step's
    first operations)."""

    def __init__(self, model, opt, held: list):
        self.model, self.opt, self.held = model, opt, held
        grid = model.grid
        self.leaf, self.index = {}, {}
        for pos in np.ndindex(grid.shape):
            for k, (path, leaf) in enumerate(_paths(grid[pos])):
                self.leaf[("p", *pos) + path] = leaf
                self.index[id(leaf)] = (pos, k)
        # owner of each (position, leaf index), and the dp sum's sources
        self.owner = {(pos, k): self.index[id(owner)]
                      for pos, pairs in model._pairs.items()
                      for k, (_, owner) in enumerate(pairs)}
        self.owners = {pos: [k for k, (leaf, owner) in enumerate(pairs) if leaf is owner]
                       for pos, pairs in model._pairs.items() if pos[0] == 0}
        self.sources = {(pos, k): [] for pos, ks in self.owners.items() for k in ks}
        for pos in np.ndindex(grid.shape):  # eager's order: positions, then leaves
            if pos[0]:
                for k in range(len(model._pairs[pos])):
                    self.sources[self.owner[(pos, k)]].append((pos, k))
        self.gbuf = {(pos, k): torch.empty_like(model._pairs[pos][k][1])
                     for pos, ks in self.owners.items() for k in ks}
        self.sub = {pos: _sub_optimizer(opt, [model._pairs[pos][k][1] for k in ks])
                    for pos, ks in self.owners.items() if ks}
        self.copies: dict = {}  # (name, position) -> a buffer there every key shares
        self.param_joins: list = []  # the parameters' copies, each step's first operations
        self.send: dict | None = None  # (source, owner position) -> [(k, offset, size, shape)]
        self.flat: dict = {}  # ("send" | "recv", source, owner position) -> flat buffer

    def copy(self, name: tuple, like: torch.Tensor, device) -> torch.Tensor:
        """The buffer of `name` (shaped and typed as `like`) on `device`,
        made once and shared by every key: one row's tower runs at one
        width a step."""
        buf = self.copies.get(name)
        if buf is None:
            buf = self.copies[name] = torch.empty_like(like, device=device)
        return buf

    def point_grads(self) -> None:
        """Every owner's ``.grad`` is its buffer (an eager step replaces it)."""
        for (pos, k), buf in self.gbuf.items():
            owner = self.model._pairs[pos][k][1]
            if owner.grad is not buf:
                owner.grad = buf


@dataclasses.dataclass(eq=False)
class _Rows:
    """One dp row's forward and backward of one tower at one token width,
    captured: its segments' graphs in a pool of their own on each device
    (``group``: a step replays another row's graphs between a segment's
    forward and its backward, and a graph captured later in a shared pool
    could have been given memory those hold), its token block (the upload's
    static input), and the host's operations a step around each segment's
    replay. ``grads`` holds each parameter's gradient from this tower, on
    the parameter's position."""
    name: tuple  # (B, tower, row, width)
    group: tuple
    segs: list
    block: torch.Tensor
    device: torch.device
    view: torch.Tensor | None = None  # the block's int32 view the graphs read
    fwd: list = dataclasses.field(default_factory=list)  # per segment: its operations
    bwd: list = dataclasses.field(default_factory=list)
    entries: list = dataclasses.field(default_factory=list)  # per segment: its forward's
    producer: dict = dataclasses.field(default_factory=dict)  # name -> its segment
    grads: dict = dataclasses.field(default_factory=dict)  # parameter name -> gradient

    def tokens(self, part: np.ndarray) -> torch.Tensor:
        """`part` uploaded into the block: its int32 view."""
        view = to_device({"t": part}, self.device, out=self.block)["t"]
        if self.view is None:
            self.view = view
        return view


@dataclasses.dataclass(eq=False)
class _Loss:
    """The loss of a batch size, captured (a pool of its own): its static
    inputs (each row's embedding, joined in), its forward and backward
    graphs' replays, the metrics and each embedding's gradient."""
    group: tuple
    seg: Segment
    bufs: dict = dataclasses.field(default_factory=dict)  # (tower, row) -> static input
    ops: list = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)
    gouts: dict = dataclasses.field(default_factory=dict)  # (tower, row) -> gradient


@dataclasses.dataclass(eq=False)
class _Key:
    """One key's step: its rows' captures by (tower, row), its loss, the
    host's operations in order after the uploads, and its tail's graphs
    (programs, graph key)."""
    rows: dict
    loss: _Loss
    ops: list = dataclasses.field(default_factory=list)
    tail: list = dataclasses.field(default_factory=list)

    def upload(self, parts: dict) -> None:
        for (t, i), rows in self.rows.items():
            rows.tokens(parts[t][i])


class SegmentedStep:
    """``train_step`` over a grid whose positions span several devices, as
    segment graphs (the module docstring): ``step(model, opt, q, d) ->
    (model, opt, metrics)`` on the host token blocks ``shard_batch`` gives.
    ``programs`` is the ``ProgramsByDevice`` that holds the graphs;
    ``graphs_per_key`` (the graphs a step replays) and ``ops_per_step``
    (the host's copies, uploads and replays a step) describe the last key
    captured. Every step holds ``compiled.LOCK`` across its uploads, its
    replays (or its eager run and the key's captures) and the copies of its
    metrics."""

    def __init__(self, tc, mesh, programs: ProgramsByDevice):
        self.tc, self.mesh, self.programs = tc, mesh, programs
        self.dp, self.tp = mesh.devices.shape
        self._keys: OrderedDict[tuple, _Key] = OrderedDict()
        self._rows: dict[tuple, _Rows] = {}
        self._losses: dict[int, _Loss] = {}
        self._ident: tuple | None = None
        self._trained: _Trained | None = None
        self.graphs_per_key = 0
        self.ops_per_step = 0

    def clear(self) -> None:
        self._keys.clear()
        self._rows.clear()
        self._losses.clear()
        self.programs.clear()
        self._trained = None

    def key(self, q_tokens: np.ndarray, d_tokens: np.ndarray) -> tuple:
        """The key of a step on these host blocks: ("train", dp, tp, B, Lq,
        Ld), the blocks' shapes once trimmed."""
        return self._key({t: self._parts(b) for t, b in zip(TOWERS, (q_tokens, d_tokens))})

    def _key(self, parts: dict) -> tuple:
        return ("train", self.dp, self.tp, sum(len(p) for p in parts[TOWERS[0]]),
                *(parts[t][0].shape[1] for t in TOWERS))

    def _parts(self, block: np.ndarray) -> list[np.ndarray]:
        """A host block's dp parts as the eager step gets them
        (``shard_batch``: the block trimmed to its sequence bucket, then
        split), as int32."""
        block = seq_bucket(block)
        n = len(block) // self.dp
        return [np.ascontiguousarray(block[i * n:(i + 1) * n], dtype=np.int32)
                for i in range(self.dp)]

    def __call__(self, model, opt, q_tokens, d_tokens):
        from mobius_rag_tpu_torch.models.train import _held

        if not (isinstance(q_tokens, np.ndarray) and isinstance(d_tokens, np.ndarray)):
            raise TypeError("a captured train_step takes the host blocks its shard_batch "
                            f"gives, not {type(q_tokens).__name__}")
        with LOCK:
            held = _held(model, opt)
            ident = identity(held)
            if ident != self._ident:  # a new model or optimizer
                self.clear()
                self._ident = ident
                self._trained = _Trained(model, opt, held)
            parts = {t: self._parts(block) for t, block in zip(TOWERS, (q_tokens, d_tokens))}
            key = self._key(parts)
            cap = self._keys.get(key)
            if cap is None:
                return model, opt, self._first(key, parts)
            self._keys.move_to_end(key)
            with torch.no_grad():
                cap.upload(parts)
                for op in self._trained.param_joins + cap.ops:
                    op()
                self._trained.point_grads()
                return model, opt, {k: v.detach().clone() for k, v in cap.loss.metrics.items()}

    def _first(self, key: tuple, parts: dict) -> dict:
        """The key's first step, eagerly on its rows' token blocks (its
        result), then the captures it lacks: the rows' towers at widths not
        seen before, the loss of a new batch size, the key's tail. A failed
        capture drops what it made and puts the parameters and the
        optimizer's state back."""
        from mobius_rag_tpu_torch.models.train import _step

        tr, devices = self._trained, self.mesh.devices
        b = key[3]
        rows, new = {}, []
        for t in TOWERS:
            for i, part in enumerate(parts[t]):
                name = (b, t, i, part.shape[1])
                if name not in self._rows:
                    dev = devices[i, 0]
                    self._rows[name] = _Rows(name, ("rows",) + name,
                                             row_segments(tr.model.cfg, t, i, self.tp),
                                             torch.empty(part.nbytes, dtype=torch.uint8,
                                                         device=dev), dev)
                    new.append(self._rows[name])
                rows[(t, i)] = self._rows[name]
        toks = {ti: r.tokens(parts[ti[0]][ti[1]]) for ti, r in rows.items()}
        new_loss = b not in self._losses
        if new_loss:
            self._losses[b] = _Loss(("loss", b), loss_segment(self.dp, self.tc.temperature))
        cap = _Key(rows, self._losses[b])
        with torch.no_grad():
            before = [t.clone() for t in tr.held]
        eager = {}
        try:
            metrics = _step(tr.model, tr.opt, [toks[("q", i)] for i in range(self.dp)],
                            [toks[("d", i)] for i in range(self.dp)], self.tc)
            eager = {(pos, k): tr.model._pairs[pos][k][1].grad for pos, k in tr.gbuf}
            tr.point_grads()  # the graphs' optimizers read the buffers
            with torch.no_grad():
                self._capture(key, cap, new, new_loss)
        except BaseException:  # nothing of the key stays, nor its eager step
            self._drop(cap.tail, [r.name for r in new], [b] if new_loss else [])
            with torch.no_grad():
                for t, v in zip(tr.held, before):
                    t.copy_(v)
            raise
        finally:  # the owners' .grad: the eager step's, in their buffers
            with torch.no_grad():
                for o, g in eager.items():
                    tr.gbuf[o].copy_(g)
            tr.point_grads()
        self._keys[key] = cap
        while len(self._keys) > MAX_KEYS:  # a key's tail, and the captures no key uses
            old = self._keys.popitem(last=False)[1]
            used = {r.name for c in self._keys.values() for r in c.rows.values()}
            self._drop(old.tail, [n for n in self._rows if n not in used],
                       [n for n in self._losses if n not in {k[3] for k in self._keys}])
        self.graphs_per_key = sum(2 * len(r.segs) for r in rows.values()) + 2 + len(cap.tail)
        self.ops_per_step = len(tr.param_joins) + len(cap.ops) + len(rows)
        return metrics

    def _drop(self, tail: list, rows: list, losses: list) -> None:
        """Forget a key's tail graphs, the rows' captures named `rows` and
        the losses of the batch sizes `losses` (their pools go with them)."""
        for programs, k in tail:
            programs.drop([k])
        for name in rows:
            self.programs.drop_group(self._rows.pop(name).group)
        for b in losses:
            self.programs.drop_group(self._losses.pop(b).group)

    def _graph(self, group, gkey: tuple, pos: tuple, held, program) -> tuple:
        """`program` captured as graph `gkey` at `pos` in `group`'s pool of
        its device: (its entry, its replay as an operation of the step)."""
        programs = self.programs.pool(self.mesh.devices[pos], group)
        entry = programs.capture(gkey, held, program)
        return entry, functools.partial(programs.replay, entry)

    def _capture(self, key: tuple, cap: _Key, new: list, new_loss: bool) -> None:
        """The graphs `key` lacks (the rows' towers in `new`, the loss when
        `new_loss`, the key's tail) and the step's host operations
        (``cap.ops``). Each join also runs once here, so that a capture
        that runs its program (a stand-in off the card) reads real values."""
        tr, devices, loss = self._trained, self.mesh.devices, cap.loss
        head = ("train", self.dp, self.tp)
        for r in new:
            self._row_forward(r, head, loss)
        if new_loss:
            seg = loss.seg
            fwd, replay = self._graph(loss.group, head + (key[3], "loss", "fwd", seg.pos,
                                                          seg.name), seg.pos, (), seg.forward)
            loss.metrics = {"loss": fwd.outputs[("loss",)].detach(),
                            "accuracy": fwd.outputs[("accuracy",)]}
            bwd, replay_b = self._graph(loss.group, head + (key[3], "loss", "bwd", seg.pos,
                                                            seg.name), seg.pos, (), seg.backward)
            fwd.outputs = {n: t.detach() for n, t in fwd.outputs.items()}
            seg.live = {}
            loss.gouts = {n[:2]: g for n, g in zip(seg.differentiable(), bwd.outputs)}
            loss.ops = [replay, replay_b]
        for r in new:
            self._row_backward(r, head, loss, key[3])
        n = len(cap.rows[(TOWERS[0], 0)].segs)
        order = [(t, k, i) for t in TOWERS for k in range(n) for i in range(self.dp)]
        cap.ops = [op for t, k, i in order for op in cap.rows[(t, i)].fwd[k]]
        cap.ops += loss.ops
        cap.ops += [op for t, k, i in reversed(order) for op in cap.rows[(t, i)].bwd[k]]
        leaf_grads: dict = {}  # parameter name -> its gradients (documents', queries')
        for t in reversed(TOWERS):
            for i in range(self.dp):
                for name, g in cap.rows[(t, i)].grads.items():
                    leaf_grads.setdefault(name, []).append(g)
        self._tail(key, cap, leaf_grads)
        want = graphs_per_key(tr.model.cfg, self.dp, self.tp)["graphs"]
        got = sum(2 * len(r.segs) for r in cap.rows.values()) + len(loss.ops) + len(cap.tail)
        if got != want:
            raise AssertionError(f"a step replays {got} graphs, the plan has {want}")

    def _row_forward(self, r: _Rows, head: tuple, loss: _Loss) -> None:
        """The forward graphs of a row's tower, in order, each behind the
        joins of what it reads from other positions; then the join of its
        embedding into the loss's input."""
        tr, devices = self._trained, self.mesh.devices
        t, i = r.name[1:3]
        made, moved = {}, {}  # name -> (position, static tensor); (name, position) -> copy

        def static(n: tuple, pos: tuple, ops: list) -> torch.Tensor:
            """Segment input `n` at `pos`: a parameter there or the token
            block, an output made there (a new autograd leaf on its
            memory), else a copy joined in (the parameters' once a step,
            shared by every key; an activation's before its reader)."""
            if n[0] == "p":
                src = tr.leaf[n]
                if (n[1], n[2]) == pos:
                    return src
                buf = tr.copies.get((n, pos))
                if buf is None:
                    buf = tr.copy((n, pos), src, devices[pos])
                    join(buf, src.detach())
                    tr.param_joins.append(functools.partial(join, buf, src.detach()))
                return buf.detach().requires_grad_(src.requires_grad)
            if n[-1] == "tok":
                return r.view
            src_pos, src, grad = made[n]
            if src_pos != pos:
                if (n, pos) not in moved:
                    buf = moved[(n, pos)] = torch.empty_like(src, device=devices[pos])
                    join(buf, src)
                    ops.append(functools.partial(join, buf, src))
                src = moved[(n, pos)]
            return src.detach().requires_grad_(grad)

        for seg in r.segs:
            ops: list = []
            seg.inputs = {n: static(n, seg.pos, ops) for n in seg.reads}
            entry, replay = self._graph(r.group, head + r.name + ("fwd", seg.pos, seg.name),
                                        seg.pos, (), seg.forward)
            ops.append(replay)
            r.fwd.append(ops)
            r.entries.append(entry)
            for n in seg.outputs:  # held detached: a join holds memory, not autograd
                out = entry.outputs[n]
                made[n] = (seg.pos, out.detach(), out.requires_grad)
                r.producer[n] = seg
        out = made[(t, i, "out")][1]
        buf = loss.bufs.get((t, i))
        if buf is None:
            buf = loss.bufs[(t, i)] = torch.empty_like(out, device=devices[0, 0])
            loss.seg.inputs[(t, i, "out")] = buf.detach().requires_grad_(True)
        join(buf, out)
        r.fwd[-1].append(functools.partial(join, buf, out))

    def _row_backward(self, r: _Rows, head: tuple, loss: _Loss, b: int) -> None:
        """The backward graphs of a row's tower, last segment first, each
        behind the joins of its outputs' gradients from other positions;
        each parameter's gradient joined onto the parameter's position."""
        tr, devices = self._trained, self.mesh.devices
        t, i = r.name[1:3]
        g = loss.gouts[(t, i)]
        r.bwd = [[] for _ in r.segs]
        if (i, 0) != (0, 0):
            buf = tr.copy(("gout", b, t, i), g, devices[i, 0])
            join(buf, g)
            r.bwd[-1].append(functools.partial(join, buf, g))
            g = buf
        r.segs[-1].contribs = {(t, i, "out"): [g]}
        for k in reversed(range(len(r.segs))):
            seg, ops = r.segs[k], r.bwd[k]
            if not seg.contribs:
                raise AssertionError(f"segment {seg.name}: no gradient reaches its outputs")
            ops.extend(seg.joins)
            entry, replay = self._graph(r.group, head + r.name + ("bwd", seg.pos, seg.name),
                                        seg.pos, (), seg.backward)
            ops.append(replay)
            # its outputs' autograd graph goes: the parameters' gradient
            # accumulators in it belong to the capture stream, and a later
            # eager backward that found them alive would accumulate there
            fwd = r.entries[k]
            fwd.outputs = {n: v.detach() for n, v in fwd.outputs.items()}
            seg.live = {}
            for n, g in zip(seg.differentiable(), entry.outputs):
                if g is None:
                    continue
                if n[0] == "p":
                    pos = (n[1], n[2])
                    if pos != seg.pos:
                        buf = tr.copy(("g", t) + n, g, devices[pos])
                        join(buf, g)
                        ops.append(functools.partial(join, buf, g))
                        g = buf
                    if n in r.grads:  # one use a tower
                        raise AssertionError(f"{n}: two gradients from one tower")
                    r.grads[n] = g
                    continue
                src = r.producer[n]
                if src.pos != seg.pos:
                    buf = torch.empty_like(g, device=devices[src.pos])
                    join(buf, g)
                    src.joins.append(functools.partial(join, buf, g))
                    g = buf
                src.contribs.setdefault(n, []).append(g)

    def _tail(self, key: tuple, cap: _Key, leaf_grads: dict) -> None:
        """The key's tail graphs and joins (the module docstring): each
        position's two towers summed (rows 1.. flat, joined into row 0's),
        the dp sums, the norm, the clip and AdamW, then the copies from the
        owners into every other position."""
        from mobius_rag_tpu_torch.models.train import clip_factors

        tr, devices, home, ops = self._trained, self.mesh.devices, (0, 0), cap.ops

        def graph(pos, name, program):
            gkey = key + ("tail", pos, name)
            entry, replay = self._graph(None, gkey, pos, tr.held, program)
            cap.tail.append((self.programs.pool(devices[pos], None), gkey))
            ops.append(replay)
            return entry

        grads = {tr.index[id(tr.leaf[n])]: got for n, got in leaf_grads.items()}
        rows = [pos for pos in np.ndindex(devices.shape) if pos[0]]
        sent = {(src, k) for src in rows for k in range(len(tr.model._pairs[src]))
                if (src, k) in grads}
        if tr.send is None:  # the flat layout, the same for every key
            tr.send = {}
            for src, k in sorted(sent):
                leaf = tr.model._pairs[src][k][0]
                layout = tr.send.setdefault((src, tr.owner[(src, k)][0]), [])
                off = layout[-1][1] + layout[-1][2] if layout else 0
                layout.append((k, off, leaf.numel(), leaf.shape))
            for (src, dpos), layout in tr.send.items():
                size = layout[-1][1] + layout[-1][2]
                for side, pos in (("send", src), ("recv", dpos)):
                    tr.flat[(side, src, dpos)] = torch.empty(size, device=devices[pos])
        if sent != {(src, k) for (src, _), layout in tr.send.items() for k, *_ in layout}:
            raise AssertionError("this key's gradients are not the first key's")
        received = {(src, k): tr.flat[("recv", src, dpos)][off:off + size].view(shape)
                    for (src, dpos), layout in tr.send.items() for k, off, size, shape in layout}

        def towers(src):
            for (s, dpos), layout in tr.send.items():
                if s == src:
                    flat = tr.flat[("send", src, dpos)]
                    for k, off, size, shape in layout:
                        _sum_into(flat[off:off + size].view(shape), grads[(src, k)])

        for src in rows:
            graph(src, ("towers",), functools.partial(towers, src))
            for (s, dpos) in tr.send:
                if s == src:
                    send, recv = tr.flat[("send", src, dpos)], tr.flat[("recv", src, dpos)]
                    join(recv, send)
                    ops.append(functools.partial(join, recv, send))

        def owner_grads(dpos) -> list:
            """Its owners' gradients: their towers', then rows 1.. in order,
            zeros where none reached; their squared sums."""
            sq = []
            for k in tr.owners[dpos]:
                buf = tr.gbuf[(dpos, k)]
                more = [received[o] for o in tr.sources[(dpos, k)] if o in received]
                if (dpos, k) in grads:
                    _sum_into(buf, grads[(dpos, k)])
                elif more:
                    buf.copy_(more.pop(0))
                else:
                    buf.zero_()
                for g in more:
                    buf.add_(g)
                sq.append((buf * buf).sum())
            return sq

        sums = {}
        others = [(0, j) for j in range(1, self.tp)]
        for dpos in others:
            sq = graph(dpos, ("dp_sum",), functools.partial(
                lambda dpos: torch.stack(owner_grads(dpos)), dpos)).outputs
            sums[dpos] = tr.copy(("sq", dpos), sq, devices[home])
            join(sums[dpos], sq)
            ops.append(functools.partial(join, sums[dpos], sq))

        def norm_and_step():
            squares = owner_grads(home) + [sums[dpos][n] for dpos in others
                                           for n in range(len(tr.owners[dpos]))]
            div, mul = clip_factors(torch.sqrt(sum(squares)), self.tc.grad_clip)
            for k in tr.owners[home]:
                tr.gbuf[(home, k)].div_(div).mul_(mul)
            tr.point_grads()  # what the graph's AdamW reads, at capture as at replay
            tr.sub[home].step()
            return torch.stack([div, mul])

        factors = graph(home, ("norm",), norm_and_step).outputs

        def step(dpos, f):
            for k in tr.owners[dpos]:
                tr.gbuf[(dpos, k)].div_(f[0]).mul_(f[1])
            tr.point_grads()
            tr.sub[dpos].step()

        for dpos in others:
            f = tr.copy(("factors", dpos), factors, devices[dpos])
            join(f, factors)
            ops.append(functools.partial(join, f, factors))
            graph(dpos, ("step",), functools.partial(step, dpos, f))
        for pairs in tr.model._pairs.values():
            ops += [functools.partial(join, leaf, owner) for leaf, owner in pairs
                    if leaf is not owner]


def _sum_into(dst: torch.Tensor, grads: list) -> None:
    """A parameter's gradient as eager autograd accumulates it, into
    `dst`: its one tower's, or the two towers' sum."""
    if len(grads) == 2:
        torch.add(grads[0], grads[1], out=dst)
    else:
        dst.copy_(grads[0])
