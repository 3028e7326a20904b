"""Captured search programs: the port of the JAX engine's compiled batch
program (``mobius_rag_tpu/query/engine.py:684-753``, ``_search_compiled``,
jitted on k, over_fetch, rrf_k, nprobe, funnel, approx, tag_level and the
input shapes, its programs kept across processes by
``mobius_rag_tpu/utils/jit_cache.py``).

On a CUDA device ``SearchEngine`` serves each batch as the replay of one
CUDA graph. The graph covers, from a static input block on, the queries'
bf16 cast, ``search_batch`` and ``pack_device``: a batch costs the host one
host-to-device copy of its prepared arrays and one replay, where the eager
program enqueues ~1,300-1,600 operators. :class:`CapturedPrograms` keeps
one graph per key:

- the program's static arguments, as the engine passes them (device k,
  funnel, over_fetch, rrf_k, nprobe, approximate top-k, tag level, the
  ANN tables' class);
- the layout of the batch as it goes up (:func:`batch_layout`: each
  array's name, shape and type; so B, the lexical union columns the
  program reads, and whether ``strict_total`` rides);
- the identity (address, shape, type) of every tensor of the tables the
  program reads: the index fields, the ANN tables, the local-gating
  structures. A graph bakes their addresses in. In-place writes (appends,
  deletes, the reserved-slab ANN maintenance) keep the identities, and a
  replay reads what they wrote, as the eager program does; ``grow``,
  ``bulk_load``, a postings resize or an ANN rebuild replace tensors, and
  every graph of the old tables is dropped at the next batch. An entry
  holds references to those tensors, so a replay never reads freed
  memory.

The first batch of a key runs the program eagerly on the key's static
inputs (it builds the kernels, makes the cuBLAS handles, loads the
modules), and that run is the batch's answer. Then the key is captured.
``torch.cuda.graph`` synchronizes the device first: the counterpart of
the JAX program's first-call compile. Nothing here catches a failed
capture or replay, and nothing serves a key eagerly after one.

Threads: captures run with ``capture_error_mode="thread_local"``. A host
sync inside the program (it runs on the capturing thread) raises during
the capture, and other threads may go on allocating device memory and
copying synchronously meanwhile, which the default "global" mode refuses
to every thread while any capture is open (the other thread's call
raises). The served API needs that: documents are
published from the request handlers and the retag thread while searches
run on the micro-batcher's thread. A device-wide synchronize from any
thread still breaks an open capture, in either mode, and
``torch.cuda.graph`` makes one on entry; so the engine holds :data:`LOCK`
across a captured batch's upload, replay or capture, and the enqueue of
its output copies. Captures then never overlap, and no thread's batch
reaches a graph's static inputs, or the pool's memory, between another
thread's replay and its copies (the port's threads share the legacy
default stream, so the order they enqueue in is the order the device
runs). The capture stream is one of PyTorch's pool streams, which do not
synchronize with the legacy default stream, so another thread's work
there neither joins nor breaks a capture. The cyclic garbage collector is
off during a capture (torch no longer collects on entry): a dead cycle
that holds a graph (an engine dropped earlier, its store's listeners
pointing back at it) collected mid-capture destroys that graph on the
capturing thread, which CUDA refuses and which invalidates the capture.

Memory: one engine's graphs share one memory pool
(``torch.cuda.graph_pool_handle``), and an LRU bounds them to
``max_graphs`` keys. A shared pool is safe under one rule, which the
engine keeps: a graph's static outputs are never read after a later
replay, of the same graph or of another graph in the pool (another
graph's replay may write its transients where this graph's outputs lie).
``search`` and ``search_pipelined`` alike enqueue their copies to
page-locked host buffers right behind the replay, on the same stream,
under :data:`LOCK`.

Launch counts: the kernel wrappers count their launches in Python, so a
replay alone would count none. Each key records the counters' deltas
during its capture, takes them back (a capture launches nothing), and
adds them on every replay.

Every single-device backend captures: exact, ivf, packed, pq and proj,
under dense and candidate-local gating and under host residency; none
reads a device value back inside its program.

A sharded engine (``parallel.ShardedEngine``, the port of the JAX
``run`` over ``shard_map``, ``mobius_rag_tpu/parallel/sharded.py``)
captures its program too. A capture records only the capturing device's
stream: work a program sent to another device would run once, at
capture, and never on replay. So the program is one graph only where
every device of its grid (``mesh.groups(axis)``) is the merge device
(``sharded.on_one_device``, as on one card named S times). Elsewhere it
runs as stages, each one graph per device (:class:`ProgramsByDevice`:
one instance per device, since a pool and a capture stream belong to
one device): every device's shards' strict counts, then every device's
arm scans, then the merge on the merge device. Between stages, outside
any graph, each stage's outputs are copied out of its pool right behind
its replay and joined into the next stage's static inputs on the other
devices (``run``'s ``inputs``: :func:`join`, ordered by a CUDA event of
the source's stream). The sharded engine keeps its own instance (its
tables are not the dense engine's, and a dense and a sharded engine
often serve one store in turns); its key is the JAX ``run``'s static
arguments as the engine passes them (device k, funnel, over_fetch,
rrf_k, nprobe, approximate top-k, the ANN tables' class) and the grid's
shape (dp, S), and a stage's its stage's name too; its tables every
shard copy's and every per-shard ANN table's tensors
(:func:`tables_held`), a stage's those on its device. A refresh that
copies rows writes in place; a re-shard and an ANN rebuild (at every
store generation) replace tensors, so each publish costs the next batch
a capture on every device.

The encoder's and the cross-encoder's forwards (the ports of
``encode_jit`` and ``score_pairs_jit``) are captured by the same class
(``models/encoder.CapturedForward``): one instance per model, so one
pool and one LRU; the key is the padded token block's (rows, length),
the tables are the module's parameters, and the rules above hold alike
(the forward launches no counted kernel, so its deltas are zero). The
data-parallel encoder (``models/encoder.MeshEncoderModel``) keeps one
such forward per distinct device of its grid, keyed on (part rows,
length); a part's static output is copied out right behind its replay.

The training step (the port of the JAX ``train_step``, jitted with
``params`` and ``opt_state`` donated; ``models/train.make_train_step``) is
captured by the same class: one instance per trainer, so one pool; the
key is ("train",), or ("train", dp, tp) on a training grid whose devices
are all one card, and the layout is the trimmed int32 token blocks' (B,
Lq, Ld). A grid over several cards crosses devices inside every layer
(the tp psum and its scatter, the dp gradient sum) in both directions, so
its step is captured as segment graphs (``models/segments.py``): each
segment's forward and backward graph and the tail's graphs per position,
held by :meth:`CapturedPrograms.capture` in each device's instance of a
:class:`ProgramsByDevice`, replayed in their capture order, joined by
copies between them. The tables held are every
parameter (every grid position's) and the optimizer's state, which
``models/train.make_optimizer`` makes before the first step: torch.optim
would make it lazily in the first step, so that its identities changed
after it. The program updates them in place, so a replay is one training
step (JAX's donation); the capture, after the key's eager first step,
runs nothing, so that step happens once. Each step sets the gradients to
None before its backward: a capture allocates them in the pool, as
transients every replay rewrites, and the clip and AdamW read them there.
The metrics are static outputs, copied under :data:`LOCK` right behind
the replay. Nothing in the step reads a device value back.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import threading
from collections import OrderedDict
from typing import Any, Callable, Sequence

import numpy as np
import torch

from mobius_rag_tpu_torch.observability import span
from mobius_rag_tpu_torch.ops.lexical import lexical_topk
from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks, proj_gated_blocks
from mobius_rag_tpu_torch.ops.topk import masked_topk

# The kernel wrappers whose launch counts a replay must add.
COUNTED = (masked_topk, proj_blocks, proj_gated_blocks, lexical_topk)
# Held across a captured batch's upload, replay or capture, and the enqueue
# of its output copies, by every engine of the process (module docstring).
LOCK = threading.Lock()
# Keys kept per engine: 6 batch sizes x ~10 union widths read, for a
# few k or tag levels.
MAX_GRAPHS = 128

# Every prepared array is 4 bytes an element on the device: uint32 bitsets
# travel as their int32 bit patterns, the queries as float32.
_DEVICE_DTYPE = {np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def batch_layout(q: dict[str, np.ndarray]) -> tuple:
    """(name, shape, device type) of each host array of a prepared batch,
    in order: the layout of its static input block."""
    return tuple((key, a.shape, _DEVICE_DTYPE[a.dtype]) for key, a in q.items())


def _views(block: torch.Tensor, layout: tuple) -> dict[str, torch.Tensor]:
    """The arrays of `layout`, cut from a uint8 block in order (every type
    is 4 bytes wide, so the views stay aligned)."""
    out, off = {}, 0
    for key, shape, dtype in layout:
        n = 4 * int(np.prod(shape, dtype=np.int64))
        out[key] = block[off:off + n].view(dtype).reshape(shape)
        off += n
    return out


def to_device(host: dict[str, np.ndarray], device: torch.device,
              out: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Host arrays (int32, uint32 bit patterns or float32) → tensors on
    `device`, uint32 as int32. On a card they travel as one block of
    page-locked memory in one non-blocking copy on the current stream, then
    are cut into views: the host does not wait for the device. ``out``, a
    uint8 block of the batch's size on `device` (a captured program's
    static input), takes the bytes in place of a fresh block."""
    arrays = {key: np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a)
              for key, a in host.items()}
    buf = torch.empty(sum(a.nbytes for a in arrays.values()), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    flat = buf.numpy()
    off = 0
    for a in arrays.values():
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        off += a.nbytes
    if out is None:
        out = buf.to(device, non_blocking=True)  # on the CPU: `buf` itself
    else:
        out.copy_(buf, non_blocking=True)
    return _views(out, batch_layout(arrays))


@dataclasses.dataclass
class _Entry:
    graph: Any  # torch.cuda.CUDAGraph, or what _capture returns
    block: torch.Tensor  # the static input block
    static: dict[str, torch.Tensor]  # its views, the program's arguments
    outputs: Any  # the static outputs, rewritten by every replay
    held: tuple  # the tables' tensors, kept alive while the graph is
    deltas: tuple[int, ...]  # launches per replay, one per COUNTED wrapper
    capture_ms: float


def tables_held(index, ann=None, local=None) -> list[torch.Tensor]:
    """Every tensor of the tables a device program reads, in a fixed order:
    the index fields (a ``DeviceIndex``), the ANN tables (any class) and
    the local-gating structures ((words, d-tag postings)). A sharded
    program's are those of every shard copy and its ANN tables."""
    held = [getattr(index, f) for f in index.fields]
    if ann is not None:
        held += [v for _, v in sorted(vars(ann).items()) if isinstance(v, torch.Tensor)]
    if local is not None:
        words, dtag = local
        held += [words, *dtag]
    return held


def identity(tensors: Sequence[torch.Tensor]) -> tuple:
    """What a graph bakes in of each tensor: its address, shape and type."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def join(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst`` ← ``src`` without a host wait, across devices. Between two
    cards the destination's current stream first waits on an event recorded
    on the source's, so that the copy reads what the source's stream wrote
    (the replay that made ``src``); torch then runs the copy on the source's
    stream, so the source's next work (its next replay) waits for it."""
    if src.device != dst.device and src.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        torch.cuda.current_stream(dst.device).wait_event(ready)
    dst.copy_(src, non_blocking=True)


def _on(device: torch.device):
    """`device` made current on a card (a replay launches on the current
    device's current stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class CapturedPrograms:
    """One engine's (or one model's) captured programs on a CUDA device
    (see the module docstring). ``run`` serves one batch; ``captures``,
    ``captures_by_key`` (a count by each graph's full key: the key and the
    batch's layout), ``capture_ms``, ``replays`` and :meth:`pool_bytes`
    report on them. Each capture is a ``programs.capture`` span (the
    observability module's), with its key."""

    def __init__(self, device, max_graphs: int = MAX_GRAPHS):
        self.device = torch.device(device)
        self._check_device()
        self.max_graphs = max_graphs
        self.graphs: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.tables: tuple | None = None  # identity of the tables of every graph kept
        self.captures = 0
        self.captures_by_key: collections.Counter = collections.Counter()
        self.capture_ms: list[float] = []  # one per capture, in order
        self.replays = 0
        self._pool = None
        self._stream = None
        # the instance whose capture stream this one's captures use (a
        # ProgramsByDevice group shares its device's: see there)
        self.stream_of: CapturedPrograms | None = None

    def _check_device(self) -> None:
        if self.device.type != "cuda":
            raise ValueError(f"captured programs run on a CUDA device, not {self.device}; "
                             "an engine on the CPU runs its program eagerly")

    def clear(self) -> None:
        """Drop every graph (and the tables they hold). A pool whose graphs
        are all gone is released and cannot take another capture, so the
        next capture opens a new one."""
        self.graphs.clear()
        self.tables = None
        self._pool = None

    def run(self, key: tuple, held: Sequence[torch.Tensor], q: dict[str, np.ndarray],
            program: Callable[[dict], Any], inputs: dict[str, torch.Tensor] | None = None
            ) -> Any:
        """One batch: `q` (host arrays) through the graph of (`key`, its
        layout) over the tables `held`, replayed, or run eagerly and
        captured when the key is new. `inputs`, device tensors on any
        device (a staged program's earlier stages' outputs), are joined
        into static tensors on this device before it (:func:`join`); the
        program finds them beside the host arrays' views, and their
        layout is part of the key. Returns the program's outputs: a
        graph's static outputs, valid until the next replay of any graph
        of this instance."""
        tables = identity(held)
        if tables != self.tables:  # the store or the ANN tables replaced a tensor
            self.clear()
            self.tables = tables
        inputs = inputs or {}
        full = (key, batch_layout(q) + tuple((name, tuple(t.shape), t.dtype)
                                             for name, t in inputs.items()))
        entry = self.graphs.get(full)
        with _on(self.device):
            if entry is None:
                return self._first(full, tuple(held), q, inputs, program)
            self.graphs.move_to_end(full)
            to_device(q, self.device, out=entry.block)
            for name, t in inputs.items():
                join(entry.static[name], t)
            entry.graph.replay()
        self.replays += 1
        for fn, d in zip(COUNTED, entry.deltas):
            fn.launches += d
        return entry.outputs

    def _first(self, full: tuple, held: tuple, q: dict[str, np.ndarray],
               inputs: dict[str, torch.Tensor], program) -> Any:
        block = torch.empty((sum(a.nbytes for a in q.values()),), dtype=torch.uint8,
                            device=self.device)
        entry = _Entry(None, block, to_device(q, self.device, out=block), None, held, (),
                       0.0)
        for name, t in inputs.items():
            entry.static[name] = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            join(entry.static[name], t)
        answer = program(entry.static)  # eager: this batch's answer
        before = [fn.launches for fn in COUNTED]
        with span("programs.capture", key=full) as sp:
            entry.graph, entry.outputs = self._capture(program, entry.static)
        entry.capture_ms = (sp.end - sp.start) / 1e6
        entry.deltas = tuple(fn.launches - n for fn, n in zip(COUNTED, before))
        for fn, n in zip(COUNTED, before):
            fn.launches = n
        self._count(full, entry.capture_ms)
        self.graphs[full] = entry
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
        return answer

    def capture(self, key: tuple, held: Sequence[torch.Tensor], program: Callable[[], Any]
                ) -> _Entry:
        """``program()`` captured as the graph of ``key``: a segment of a
        program its caller stages, reading and writing only device tensors
        it holds (static inputs, earlier segments' static outputs, `held`:
        the tables it reads or writes in place, kept alive with the graph).
        Nothing runs. Returns the entry (``.outputs``, its static outputs);
        :meth:`replay` runs it. Unlike :meth:`run`, the caller keeps the
        order (graphs of one pool replay in the order they were captured)
        and the LRU: it drops a key's graphs together (:meth:`drop`)."""
        before = [fn.launches for fn in COUNTED]
        with span("programs.capture", key=key) as sp:
            graph, outputs = self._capture(lambda _: program(), None)
        ms = (sp.end - sp.start) / 1e6
        deltas = tuple(fn.launches - n for fn, n in zip(COUNTED, before))
        for fn, n in zip(COUNTED, before):
            fn.launches = n
        entry = _Entry(graph, None, {}, outputs, tuple(held), deltas, ms)
        self.graphs[(key, ())] = entry
        self._count((key, ()), ms)
        return entry

    def _count(self, full: tuple, ms: float) -> None:
        self.captures += 1
        self.captures_by_key[full] += 1
        self.capture_ms.append(ms)

    def replay(self, entry: _Entry) -> None:
        """One replay of a graph that :meth:`capture` made."""
        with _on(self.device):
            entry.graph.replay()
        self.replays += 1
        for fn, d in zip(COUNTED, entry.deltas):
            fn.launches += d

    def drop(self, keys) -> None:
        """Forget the graphs of `keys` (:meth:`capture`'s)."""
        for key in keys:
            self.graphs.pop((key, ()), None)

    def _capture(self, program, static: dict) -> tuple[Any, Any]:
        """Capture `program` on `static` into a new graph of the shared
        pool. Returns (graph, its static outputs)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()  # a dead cycle freed mid-capture could destroy a graph here
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=self._pool, stream=self.capture_stream(),
                    capture_error_mode="thread_local"):
                outputs = program(static)
        finally:
            if collecting:
                gc.enable()
        return graph, outputs

    def capture_stream(self) -> "torch.cuda.Stream":
        """The stream this instance captures on, made at first use: its own,
        or ``stream_of``'s."""
        if self.stream_of is not None:
            return self.stream_of.capture_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def pool_bytes(self) -> int:
        """Bytes the graphs' shared pool holds on the device (its segments
        in the caching allocator's snapshot)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)


class ProgramsByDevice:
    """The captured programs of a program staged over several devices: one
    :class:`CapturedPrograms` per device (its own pool, capture stream and
    LRU), made up front, so that it raises off a card; ``[device]`` is
    that device's. :meth:`pool` adds instances of a named group (a pool
    of their own on each device, for graphs whose replays interleave with
    others'), :meth:`drop_group` releases one. A group's instance captures
    on its device's capture stream: a training segment's forward graph,
    captured with autograd on, keeps the AccumulateGrad nodes of the
    parameters it reads alive until its backward is captured, and each
    such node belongs to the stream it was made on; another group's
    segment reading the same parameter on another stream would feed it
    from there (torch's AccumulateGrad stream mismatch). ``captures``,
    ``captures_by_key``, ``capture_ms``, ``replays``, ``graphs`` (both keyed
    ((device, *key), layout)) and :meth:`pool_bytes` report on all of them
    (the counts include dropped groups')."""

    def __init__(self, devices: Sequence, max_graphs: int = MAX_GRAPHS,
                 make: Callable[..., CapturedPrograms] | None = None):
        self.make, self.max_graphs = make or CapturedPrograms, max_graphs
        self.by_device = {d: self.make(d, max_graphs)
                          for d in dict.fromkeys(torch.device(d) for d in devices)}
        self.groups: dict[tuple, CapturedPrograms] = {}  # (group, device) -> its programs
        # dropped groups' captures, capture ms, replays, captures by key
        self._gone = (0, [], 0, collections.Counter())

    def __getitem__(self, device) -> CapturedPrograms:
        return self.by_device[torch.device(device)]

    def pool(self, device, group=None) -> CapturedPrograms:
        """`device`'s programs of `group` (None: ``[device]``)."""
        device = torch.device(device)
        if group is None:
            return self.by_device[device]
        if (group, device) not in self.groups:
            programs = self.groups[(group, device)] = self.make(device, self.max_graphs)
            programs.stream_of = self.by_device[device]
        return self.groups[(group, device)]

    def drop_group(self, group) -> None:
        """Forget `group`'s graphs on every device, and its pools."""
        for gd in [gd for gd in self.groups if gd[0] == group]:
            p = self.groups.pop(gd)
            captures, ms, replays, by_key = self._gone
            self._gone = (captures + p.captures, ms + p.capture_ms, replays + p.replays,
                          by_key + self._by_device(p, p.captures_by_key))
            p.clear()

    def _all(self) -> list[CapturedPrograms]:
        return [*self.by_device.values(), *self.groups.values()]

    @property
    def captures(self) -> int:
        return self._gone[0] + sum(p.captures for p in self._all())

    @property
    def captures_by_key(self) -> collections.Counter:
        return sum((self._by_device(p, p.captures_by_key) for p in self._all()),
                   self._gone[3])

    @staticmethod
    def _by_device(p: CapturedPrograms, counts: collections.Counter) -> collections.Counter:
        return collections.Counter({((str(p.device), *key), layout): n
                                    for (key, layout), n in counts.items()})

    @property
    def capture_ms(self) -> list[float]:
        return self._gone[1] + [ms for p in self._all() for ms in p.capture_ms]

    @property
    def replays(self) -> int:
        return self._gone[2] + sum(p.replays for p in self._all())

    @property
    def graphs(self) -> dict:
        return {((str(p.device), *key), layout): entry for p in self._all()
                for (key, layout), entry in p.graphs.items()}

    def clear(self) -> None:
        for p in self.by_device.values():
            p.clear()
        for group in {g for g, _ in self.groups}:
            self.drop_group(group)

    def pool_bytes(self) -> int:
        return sum(p.pool_bytes() for p in self._all())
