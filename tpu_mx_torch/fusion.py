"""Lazy elementwise fusion engine for the imperative NDArray path, from
``tpu_mx/fusion.py``.

Inside an ``engine.bulk()`` scope (or with ``TPUMX_FUSION=1`` always on),
``ops._apply`` on a *fusible* op (elementwise, broadcast, cast, the
reduction tails, ``sgd_update``: the ops that carry the reference's fuse
keys) appends a node to this thread's pending :class:`FusionSegment`
instead of running it, and returns an NDArray whose tensor is a lazy
node.  Any barrier flushes the segment as one unit:

  - a read of the tensor (``wait_to_read``, ``asnumpy``, ``asscalar``,
    any ``_data`` access: the NDArray property routes every read here),
  - a non-fusible consumer (it unwraps its arguments),
  - an autograd tape boundary (entering or leaving ``record()``/
    ``pause()``, or ``backward()``),
  - the segment reaching the engine's bulk size,
  - ``engine.bulk()`` scope exit or ``waitall()``.

Flushing.  A segment's chain key is the reference's: the op keys, the
dataflow wiring, which nodes are live outputs (handles still reachable),
the number of external inputs.  Python scalars are external inputs, so
one key serves every scalar value, as in the reference; ``stats`` and
:func:`cache_stats` count hits and misses on that key.

  - Tensors on the CPU: the flush replays the recorded ops eagerly, in
    order.  The result is eager's, bit for bit.
  - Tensors on the card: the replay is captured once per (chain key,
    scalar values, input shapes, strides, dtypes, device) in a
    ``torch.cuda.CUDAGraph`` (after a warm-up on a side stream) and
    replayed: one graph launch a flush in place of one launch an op, the
    part the reference's memoised ``jax.jit`` plays.  The inputs are
    copied into the graph's static buffers and the live outputs cloned
    out before the next replay can overwrite them.  The cache keeps at
    most ``GRAPH_CACHE_SIZE`` graphs holding at most ``GRAPH_CACHE_BYTES``
    of the card's memory between them (least recently used goes first).
    An op that cannot be captured raises, naming the segment's ops; there
    is no eager replay in its place.  Scalars are baked into the kernels
    a graph holds, so they key the graph: a learning rate that changes
    every step captures a graph every step, and the byte bound keeps
    what those graphs hold to a fixed share of the card.  The kernels
    are eager's, so a fused result is bit-equal to eager's: unlike XLA
    the capture does not contract or reassociate anything.

A flushed segment under ``record()`` is one tape node: a
``torch.autograd.Function`` whose backward recomputes the replay with
gradients on and calls ``torch.autograd.grad`` (the reference's
rematerialising ``jax.vjp`` pullback).  Outputs of nondiff nodes
(``sgd_update``, ``BlockGrad``, ``zeros_like``, ...) are constants, as
eager leaves them.

Deferred errors: an invalid op (a broadcast mismatch) raises at the
flush barrier, not at the call, and the error names the segment's ops.
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict

import torch

from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["enabled", "flush", "stats", "reset_stats", "pending_ops",
           "cache_stats", "graph_stats", "FusionSegment"]


class _TLS(threading.local):
    def __init__(self):
        self.pending = None      # FusionSegment being built, or None
        self.scope_depth = 0     # engine.bulk() nesting depth
        self.suppress_depth = 0  # bulk(size<=1) anti-fusion nesting


_TLS_ = _TLS()

# chain keys seen by the forward flush and by the backward recompute
_FWD_CACHE = {}
_BWD_CACHE = {}

#: captured CUDA graphs kept at once, and the card memory they may hold
#: (static inputs, outputs and every intermediate); the least recently
#: used graph goes first
GRAPH_CACHE_SIZE = 64
GRAPH_CACHE_BYTES = 4 << 30
_GRAPHS = OrderedDict()          # graph key -> _Graph
_graph_lock = threading.Lock()
_graph_counts = {"captures": 0, "replays": 0, "evictions": 0}
_graph_bytes = [0]               # what the cached graphs hold

stats = {
    "ops_fused": 0,          # ops appended to segments
    "segments_flushed": 0,   # segments executed
    "segments_dead": 0,      # segments whose every output died unread
    "cache_hits": 0,
    "cache_misses": 0,
    "flush_reasons": {},     # reason -> count
}


def reset_stats():
    for k in ("ops_fused", "segments_flushed", "segments_dead",
              "cache_hits", "cache_misses"):
        stats[k] = 0
    stats["flush_reasons"] = {}


def clear_cache():
    """Drop the chain keys and the captured graphs (test hook)."""
    _FWD_CACHE.clear()
    _BWD_CACHE.clear()
    with _graph_lock:
        _GRAPHS.clear()
        _graph_bytes[0] = 0


def cache_stats():
    """Chain-key counts plus hit/miss totals, from the telemetry registry
    (``fusion.cache_hits`` / ``fusion.cache_misses`` /
    ``fusion.flushes``), in the reference's shape."""
    def val(name):
        m = _telemetry.get(name)
        return int(m.value) if m is not None else 0

    return {"programs": len(_FWD_CACHE),
            "bwd_programs": len(_BWD_CACHE),
            "hits": val("fusion.cache_hits"),
            "misses": val("fusion.cache_misses"),
            "segments_flushed": val("fusion.flushes")}


def graph_stats():
    """The card's graph layer: graphs and bytes held, the bounds, and the
    captures, replays and evictions since the process began."""
    return {"graphs": len(_GRAPHS), "capacity": GRAPH_CACHE_SIZE,
            "bytes": _graph_bytes[0], "capacity_bytes": GRAPH_CACHE_BYTES,
            **_graph_counts}


# os.environ.get costs microseconds a call (an encode in os.py), too much
# for a check at every op; on POSIX CPython read the live bytes-keyed
# mapping directly (putenv and monkeypatch.setenv keep it current)
_ENV_DATA = getattr(os.environ, "_data", None) if os.name == "posix" \
    else None
if isinstance(_ENV_DATA, dict):
    def _fusion_env():
        v = _ENV_DATA.get(b"TPUMX_FUSION")
        return v.decode() if v is not None else None
else:  # pragma: no cover — another os.environ layout
    def _fusion_env():
        return os.environ.get("TPUMX_FUSION")


def enabled():
    """Is fusion active on this thread now?  ``TPUMX_FUSION=1`` forces it
    on, ``TPUMX_FUSION=0`` off (plain eager dispatch, even inside
    ``engine.bulk()``); unset, it is on inside ``engine.bulk()`` scopes.
    A ``bulk(size<=1)`` scope turns it off even under ``TPUMX_FUSION=1``
    (the reference's op-by-op escape hatch)."""
    if _TLS_.suppress_depth > 0:
        return False
    env = _fusion_env()
    if env == "1":
        return True
    if env == "0":
        return False
    return _TLS_.scope_depth > 0


def enter_scope():
    _TLS_.scope_depth += 1


def exit_scope():
    _TLS_.scope_depth -= 1
    flush("scope_exit")


def enter_suppress():
    flush("suppress_scope")  # ops before the scope must not see barriers move
    _TLS_.suppress_depth += 1


def exit_suppress():
    _TLS_.suppress_depth -= 1


def pending_ops():
    """Number of ops in this thread's pending segment."""
    seg = _TLS_.pending
    return len(seg.fns) if seg is not None else 0


class _Lazy:
    """What a lazy NDArray holds in ``_lazy``: (segment, node index)."""

    __slots__ = ("segment", "index")

    def __init__(self, segment, index):
        self.segment = segment
        self.index = index


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(tuple(x.shape), x.stride(),
                                   dtype=x.dtype, device="meta")
    return x


class FusionSegment:
    """A pending bulked op sequence: straight-line dataflow.

    Node inputs are specs: ``("e", i)`` external input i, ``("n", i)``
    output of node i.  An external input is a tensor or a Python scalar
    (passed to the op as the scalar it was, so promotion is eager's)."""

    __slots__ = ("fns", "keys", "specs", "names", "nondiffs", "ext",
                 "ext_handles", "ext_ids", "handles", "avals", "bulk_size",
                 "device")

    def __init__(self, bulk_size):
        self.fns = []           # per node: the op on tensors
        self.keys = []          # per node: hashable op key (incl. params)
        self.specs = []         # per node: tuple of input specs
        self.names = []         # per node: display name for errors
        self.nondiffs = []      # per node: eager-path nondiff flag
        self.ext = []           # external tensors/scalars, first-use order
        self.ext_handles = []   # the NDArray handle per ext (None if raw)
        self.ext_ids = {}       # dedup key -> ext index
        self.handles = []       # per node: weakref to the result NDArray
        self.avals = []         # per node: meta tensor, computed lazily
        self.bulk_size = bulk_size
        self.device = None      # the device of the segment's tensors

    def _ext_index(self, value, handle):
        # two handles can share a tensor (detach()): dedup by the HANDLE,
        # so each receives its own gradient
        if handle is not None:
            key = ("h", id(handle))
        elif isinstance(value, torch.Tensor):
            key = ("t", id(value))
        else:
            key = ("s", type(value), repr(value))
        idx = self.ext_ids.get(key)
        if idx is None:
            idx = len(self.ext)
            self.ext_ids[key] = idx
            self.ext.append(value)
            self.ext_handles.append(handle)
        return idx

    def node_aval(self, i):
        """Node i's output as a meta tensor (shape, dtype, strides), from
        the op run on meta tensors: nothing executes."""
        if self.avals[i] is None:
            ins = []
            for kind, v in self.specs[i]:
                ins.append(_meta(self.ext[v]) if kind == "e"
                           else self.node_aval(v))
            with torch.no_grad():
                self.avals[i] = self.fns[i](*ins)
        return self.avals[i]


def aval_of(lazy):
    return lazy.segment.node_aval(lazy.index)


def device_of(lazy):
    return lazy.segment.device or torch.device("cpu")


_NDARRAY = None


def _ndarray_cls():
    global _NDARRAY
    if _NDARRAY is None:
        from .ndarray.ndarray import NDArray
        _NDARRAY = NDArray
    return _NDARRAY


def _lazy_ndarray(NDArray, segment, index):
    out = NDArray.__new__(NDArray)
    out._buf = None
    out._lazy = _Lazy(segment, index)
    out._grad = None
    out._grad_req = "null"
    return out


def _fallback():
    _telemetry.counter("fusion.eager_fallbacks").inc()


def append(fn, args, name, key, nondiff):
    """Append one fusible op to this thread's pending segment.

    Returns the lazy result NDArray, or None when an argument is not
    representable in the segment (not an array, tensor or Python
    scalar, or a tensor on another device than the segment's): the
    caller then runs the op eagerly."""
    NDArray = _ndarray_cls()
    seg = _TLS_.pending
    if seg is None:
        from . import engine
        seg = FusionSegment(max(2, engine._bulk_size))
        _TLS_.pending = seg

    specs = []
    for a in args:
        if isinstance(a, NDArray):
            lz = a._lazy
            if lz is not None and lz.segment is seg:
                specs.append(("n", lz.index))
                continue
            value, handle = a._data, a
        elif isinstance(a, (bool, int, float)):
            specs.append(("e", seg._ext_index(a, None)))
            continue
        elif isinstance(a, torch.Tensor):
            value, handle = a, None
        else:
            _fallback()
            return None
        if seg.device is None:
            seg.device = value.device
        elif value.device != seg.device:
            _fallback()
            return None
        specs.append(("e", seg._ext_index(value, handle)))

    idx = len(seg.fns)
    seg.fns.append(fn)
    seg.keys.append(key)
    seg.specs.append(tuple(specs))
    seg.names.append(name)
    seg.nondiffs.append(bool(nondiff))
    seg.avals.append(None)
    out = _lazy_ndarray(NDArray, seg, idx)
    seg.handles.append(weakref.ref(out))
    stats["ops_fused"] += 1
    if idx + 1 >= seg.bulk_size:
        flush("bulk_size")
    return out


def realize(handle):
    """Barrier from NDArray._data: flush the segment backing `handle`."""
    lz = handle._lazy
    if lz is None:
        return
    if lz.segment is _TLS_.pending:
        flush("read_barrier")
    else:  # pragma: no cover — a segment of another thread, still owed
        _execute(lz.segment, "read_barrier")
    if handle._lazy is not None:  # pragma: no cover — defensive
        raise RuntimeError("fusion flush failed to realize a lazy NDArray")


def flush(reason="barrier"):
    """Flush this thread's pending segment (no-op when none)."""
    seg = _TLS_.pending
    if seg is None:
        return
    _TLS_.pending = None
    _execute(seg, reason)


def _replay(fns, specs, nondiffs, ext):
    """Every node's value, the ops run in order on ``ext``.  A nondiff
    node's output is detached: a constant, as eager leaves it."""
    vals = []
    for fn, sp, nd_ in zip(fns, specs, nondiffs):
        out = fn(*[ext[v] if kind == "e" else vals[v] for kind, v in sp])
        vals.append(out.detach() if nd_ else out)
    return vals


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.stride(), x.dtype)
    return ("s", type(x).__name__, repr(x))


def _storage_bytes(tensors):
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class _Graph:
    """One captured replay: static inputs, the graph, static outputs.
    ``nbytes`` is the card memory it holds: the static inputs and every
    node's output (the graph's pool keeps room for its intermediates)."""

    def __init__(self, seg, out_idxs):
        dev = seg.device
        self.static = [x.detach().clone() if isinstance(x, torch.Tensor)
                       else x for x in seg.ext]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            _replay(seg.fns, seg.specs, seg.nondiffs, self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph, stream=side):
            vals = _replay(seg.fns, seg.specs, seg.nondiffs, self.static)
            self.outs = [vals[i] for i in out_idxs]
        self.nbytes = _storage_bytes(self.static + vals)

    def run(self, ext):
        for s, x in zip(self.static, ext):
            if isinstance(s, torch.Tensor):
                s.copy_(x)
        self.graph.replay()
        return [o.clone() for o in self.outs]


def _cache_put(gkey, g):
    """Admit graph ``g`` and drop the least recently used others until
    the cache is within ``GRAPH_CACHE_SIZE`` and ``GRAPH_CACHE_BYTES``
    (the newest stays, even alone above the byte bound).  Call with
    ``_graph_lock`` held."""
    _GRAPHS[gkey] = g
    _graph_bytes[0] += g.nbytes
    while len(_GRAPHS) > 1 and (len(_GRAPHS) > GRAPH_CACHE_SIZE or
                                _graph_bytes[0] > GRAPH_CACHE_BYTES):
        _, old = _GRAPHS.popitem(last=False)
        _graph_bytes[0] -= old.nbytes
        _graph_counts["evictions"] += 1


def _graph_run(seg, chain_key, out_idxs):
    gkey = (chain_key, seg.device, tuple(_signature(x) for x in seg.ext))
    with _graph_lock:
        g = _GRAPHS.get(gkey)
        if g is None:
            try:
                g = _Graph(seg, out_idxs)
            except Exception as e:
                raise RuntimeError(
                    f"fusion: the segment [{' -> '.join(seg.names)}] cannot "
                    f"be captured in a CUDA graph ({type(e).__name__}: "
                    f"{e}); run it outside engine.bulk() or with "
                    "TPUMX_FUSION=0") from e
            _graph_counts["captures"] += 1
            _cache_put(gkey, g)
        else:
            _GRAPHS.move_to_end(gkey)
        _graph_counts["replays"] += 1
        return g.run(seg.ext)


class _Run:
    """What one flush runs, and what its tape node needs to recompute."""

    def __init__(self, seg, chain_key, out_idxs):
        self.fns, self.specs, self.nondiffs = seg.fns, seg.specs, \
            seg.nondiffs
        self.seg, self.chain_key, self.out_idxs = seg, chain_key, out_idxs
        self.scalars = {i: x for i, x in enumerate(seg.ext)
                        if not isinstance(x, torch.Tensor)}
        self.out_masks = None   # per output: the grad inputs it reaches
        self.needed = ()        # ext indices that receive a gradient

    def forward(self):
        if self.seg.device is not None and self.seg.device.type == "cuda":
            return _graph_run(self.seg, self.chain_key, self.out_idxs)
        with torch.no_grad():
            vals = _replay(self.fns, self.specs, self.nondiffs, self.seg.ext)
        return [vals[i] for i in self.out_idxs]


class _SegmentFunction(torch.autograd.Function):
    """A flushed segment as one tape node; backward recomputes it."""

    @staticmethod
    def forward(ctx, run, *ext):
        outs = run.forward()
        seen = set(id(x) for x in ext)
        for k, o in enumerate(outs):
            if id(o) in seen:           # an input returned as is
                outs[k] = o.view_as(o)
            seen.add(id(outs[k]))
        ctx.run = run
        ctx.save_for_backward(*[x for x in ext
                                if isinstance(x, torch.Tensor)])
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*[
            o for o, m in zip(outs, run.out_masks)
            if not (m and o.is_floating_point())])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        saved = iter(ctx.saved_tensors)
        ext = [run.scalars[i] if i in run.scalars else next(saved)
               for i in range(len(run.seg.ext))]
        n_ext = len(ext)
        _BWD_CACHE.setdefault((run.chain_key, run.needed), True)
        with torch.enable_grad():
            ins = list(ext)
            for i in run.needed:
                ins[i] = ext[i].detach().requires_grad_(True)
            vals = _replay(run.fns, run.specs, run.nondiffs, ins)
            pairs = [(vals[j], g) for j, g in zip(run.out_idxs, grads)
                     if g is not None and vals[j].requires_grad]
            if pairs:
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [ins[i] for i in run.needed],
                                          [g for _, g in pairs],
                                          allow_unused=True)
            else:
                got = [None] * len(run.needed)
        out = [None] * n_ext
        for i, g in zip(run.needed, got):
            out[i] = g
        return (None,) + tuple(out)


def _tape_plan(seg, out_idxs):
    """(per output, a bitmask of the inputs requiring a gradient that
    reach it through differentiable nodes; the inputs any output
    reaches).  A path through a nondiff node is a constant, as eagerly;
    an output joins the tape when its mask is set and it is floating."""
    bits = {}
    for i, x in enumerate(seg.ext):
        if isinstance(x, torch.Tensor) and x.requires_grad:
            bits[i] = 1 << i
    masks = []
    for ni in range(len(seg.fns)):
        if seg.nondiffs[ni]:
            masks.append(0)
            continue
        m = 0
        for kind, v in seg.specs[ni]:
            m |= bits.get(v, 0) if kind == "e" else masks[v]
        masks.append(m)
    out_masks = [masks[i] for i in out_idxs]
    needed = 0
    for m in out_masks:
        needed |= m
    return out_masks, tuple(i for i in sorted(bits) if needed & bits[i])


def _execute(seg, reason):
    from . import autograd

    stats["flush_reasons"][reason] = \
        stats["flush_reasons"].get(reason, 0) + 1
    if not seg.fns:
        return
    _telemetry.counter("fusion.flush_cause", cause=reason).inc()
    _telemetry.histogram("fusion.segment_ops",
                         buckets=_telemetry.SEGMENT_OPS_BUCKETS,
                         unit="ops").observe(len(seg.fns))

    # live outputs: node results whose handle is still reachable and still
    # lazy on THIS segment; dead intermediates stay inside the replay
    live = []
    for i, ref in enumerate(seg.handles):
        h = ref()
        if h is not None and h._lazy is not None \
                and h._lazy.segment is seg:
            live.append((i, h))
    if not live:
        stats["segments_dead"] += 1
        _telemetry.counter("fusion.segments_dead").inc()
        return

    out_idxs = tuple(i for i, _ in live)
    chain_key = (tuple(seg.keys), tuple(seg.specs),
                 tuple(seg.nondiffs), len(seg.ext), out_idxs)
    if chain_key in _FWD_CACHE:
        stats["cache_hits"] += 1
        _telemetry.counter("fusion.cache_hits").inc()
    else:
        stats["cache_misses"] += 1
        _telemetry.counter("fusion.cache_misses").inc()
        _FWD_CACHE[chain_key] = out_idxs

    run = _Run(seg, chain_key, out_idxs)
    try:
        taped = False
        if autograd.is_recording():
            run.out_masks, run.needed = _tape_plan(seg, out_idxs)
            taped = bool(run.needed)
        results = (_SegmentFunction.apply(run, *seg.ext) if taped
                   else run.forward())
    except Exception as e:
        msg = (f"{e}\n(raised while flushing a fused op segment "
               f"[{' -> '.join(seg.names)}]; with fusion enabled, op errors "
               f"surface at the flush barrier, not the op call site)")
        try:
            err = type(e)(msg)
        except Exception:  # noqa: BLE001 — a constructor of other arguments
            err = RuntimeError(msg)
        raise err from e

    for (i, h), r in zip(live, results):
        h._buf = r
        h._lazy = None
    stats["segments_flushed"] += 1
    # stats["ops_fused"] counts appends (segments that die unread too);
    # fusion.ops_fused counts only ops that executed fused
    _telemetry.counter("fusion.flushes").inc()
    _telemetry.counter("fusion.ops_fused").inc(len(seg.fns))
    _tracing.emit("fusion.flush", cause=reason, ops=len(seg.fns))
