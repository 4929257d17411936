"""The mixture-of-experts FFN of ``tpu_mx/parallel/moe.py``, on one
device.

The function is the reference's ``_moe_forward``: a float32 router and
softmax over ``E`` experts; the top ``k`` experts of each token picked
in order (first-choice picks before second-choice ones); the picked
gates renormalised for ``k > 1`` and the raw probability for ``k = 1``;
each expert takes at most ``C = ceil(capacity_factor·S·k/E)`` tokens,
slots going to first choices before any second choice (int32 position
counts), and a token past capacity contributes zero (the residual
around the layer carries it); the Switch auxiliary ``E·Σ frac·mean_prob``
in float32; the output in the input's dtype.

The reference builds ``(S, E, C)`` one-hot dispatch and combine tensors
and lets XLA fuse the einsums.  Eager PyTorch would keep them (2.7 GB
each at BERT-base's 32 x 512 tokens, 8 experts), so the port computes
the same routing by index: each (round, token) gets its expert and slot,
the experts' ``(E, C, U)`` inputs are gathered by slot
(``index_select``), the experts run as one batched product, and each
token gathers its slots' outputs back with its gates.  A slot holds one
token and a token at most ``k`` slots, so the gathers' backwards add at
most ``k`` values into a row that counts (exact whatever the order:
only the zero row, which every empty slot and dropped token reads,
takes more, and its gradient is dropped).

The expert weights are stacked on a leading ``E`` axis, as in the
reference; :func:`moe_sharding_rules` returns its ``ep`` rules.  Inside
the train step's SPMD region over a mesh with an ``ep`` axis, a rank
computes its ``E/ep`` experts (``collectives.take`` of their weights;
the routing, the gates and the auxiliary term are the same on every
rank) and the partial outputs are summed over ``ep``: the layer's
function is the one-device one.

Where the step's batch is split over ranks along its rows (``dp``) or
its sequence (``sp``) (``collectives.token_split``), the layer routes
the global batch, as the reference's mesh program does: the capacity is
``ceil(cf·S_global·k/E)``; a token's slot is its place in the global
count, in the global batch's token order (row by row, each row's
sequence in order), which walks the ``k`` rounds one after another, each
starting at the totals of the rounds before it.  So in round ``j`` a
token of row ``b`` counts, before its own row's earlier tokens on its
rank, every token of the rows before ``b`` and of the sequence blocks
before its rank's in row ``b``, from every rank: one all-gather of the
ranks' per-row ``(rows, E)`` counts a round.  The auxiliary term's
``frac`` and ``mean_prob`` are global means (``collectives.batch_sum``,
whose backward adds the cotangents).  Under the compressed per-shard
reduction each rank routes its own tokens, as the reference's per-shard
program does.  A batch split along another dimension raises
:class:`MXNetError` (not ported).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..ndarray import ops
from . import collectives as _coll
from .mesh import P

__all__ = ["MoEFFN", "moe_sharding_rules", "moe_route"]


def moe_sharding_rules():
    """Expert-parallel rules: the stacked expert axis shards over `ep`;
    the gate is replicated."""
    return [
        (r"expert_w1$", P("ep", None, None)),
        (r"expert_b1$", P("ep", None)),
        (r"expert_w2$", P("ep", None, None)),
        (r"expert_b2$", P("ep", None)),
        (r"gate_weight$", P(None, None)),
    ]


def _one_hot(idx, n, dtype):
    # a comparison, not F.one_hot (zeros + an in-place scatter, which a
    # remat policy that keeps every output refuses)
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_route(probs, top_k, capacity, split=None, rows=1):
    """The reference's routing of ``probs`` ``(S, E)`` (float32): per
    round ``r < top_k``, each token's expert ``experts[r]`` (int64,
    ``(S,)``), its slot in that expert ``slots[r]`` (int32 position
    count, first choices before second), whether the slot is within
    capacity ``kept[r]``, and its gate ``gates[r]`` (differentiable in
    ``probs``; renormalised over the picks for ``top_k > 1``).
    ``split``: ``collectives.token_split()`` of a batch split over
    ranks, whose ``S`` tokens are this rank's ``rows`` rows of
    ``S / rows`` tokens each: the slots are then the global batch's
    (module docstring)."""
    s, e = probs.shape
    masked = probs.detach()
    experts, gates = [], []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                       # (S,)
        experts.append(idx)
        gates.append(probs.gather(1, idx[:, None])[:, 0])
        masked = masked * (1.0 - _one_hot(idx, e, masked.dtype))
    if top_k > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    prev = torch.zeros(e, dtype=torch.int32, device=probs.device)
    slots, kept = [], []
    for idx in experts:
        # position among the earlier tokens of the same expert: one flat
        # scan over the (E, S) one-hot rows, each row's start subtracted
        # (a scan along S of (S, E) runs E columns, slowly, on the card)
        onehot = _one_hot(idx, e, torch.int32).t().contiguous()  # (E, S)
        run = torch.cumsum(onehot.reshape(-1), 0, dtype=torch.int32) \
            .view(e, s)
        start = run[:, :1] - onehot[:, :1]
        counts = run[:, -1] - start[:, 0]                        # (E,)
        pos = run - onehot - start + prev[:, None]               # (E, S)
        if split is not None:
            # the tokens every rank holds before each of this rank's rows
            # in the global order, less those of its own earlier rows
            mesh, axes, (nr, ri, ns, si) = split
            mine = onehot.view(e, rows, s // rows).sum(
                -1, dtype=torch.int32).t()                        # (rows, E)
            every = _coll._gather(mine[None], mesh, axes, 0)     # (R, rows, E)
            glob = every.view(nr, ns, rows, e).transpose(1, 2).reshape(-1, e)
            before = torch.cumsum(glob, 0, dtype=torch.int32) - glob
            own = torch.cumsum(mine, 0, dtype=torch.int32) - mine
            shift = before.view(nr, rows, ns, e)[ri, :, si] - own
            pos = pos + shift.t().repeat_interleave(s // rows, dim=1)
            counts = glob.sum(0, dtype=torch.int32)
        slot = pos.gather(0, idx[None, :])[0]
        slots.append(slot)
        kept.append(slot < capacity)
        prev = prev + counts
    return experts, slots, kept, gates


def _moe_forward(x, gw, w1, b1, w2, b2, *, top_k, capacity, act,
                 split=None, rows=1):
    """Routing and expert compute on flattened tokens ``(S, U)``; returns
    ``(y, aux)``, ``y`` in ``x``'s dtype and ``aux`` float32.  Over
    ``ep`` (module docstring) the rank's experts run and the outputs
    are summed over the axis; with ``split`` (:func:`moe_route`) the
    routing and the auxiliary term are the global batch's."""
    s, u = x.shape
    e = gw.shape[0]
    probs = torch.softmax(x.float() @ gw.float().t(), dim=-1)   # (S, E)
    experts, slots, kept, gates = moe_route(probs, top_k, capacity, split,
                                            rows)
    mesh, ep, r = _coll.split_over("ep")
    lo, hi = r * (e // ep), (r + 1) * (e // ep)
    if ep > 1:
        own = torch.arange(lo, hi, device=x.device)
        w1, b1, w2, b2 = (_coll.take(w, mesh, "ep", 0, own)
                          for w in (w1, b1, w2, b2))
        # the same tokens and gates on every rank, each read by its own
        # experts: their gradients are summed over ep
        x_in = _coll.copy_to(x, mesh, "ep")
        gates = [_coll.copy_to(g, mesh, "ep") for g in gates]
    else:
        x_in = x
    # each kept (round, token) at row expert·C + slot of the experts'
    # inputs; empty rows read the zero row S
    flat = [torch.where(k, i * capacity + sl.long(), e * capacity)
            for i, sl, k in zip(experts, slots, kept)]
    src = torch.full((e * capacity + 1,), s, dtype=torch.long,
                     device=x.device)
    tokens = torch.arange(s, device=x.device)
    for f in flat:   # out of place: a remat policy may keep ``src``
        src = src.index_put((f,), tokens)
    # index_select, not advanced indexing: its backward adds into rows
    # (at most k a row that counts), where indexing's sorts every index
    x_pad = torch.cat([x_in, x_in.new_zeros(1, u)])
    expert_in = x_pad.index_select(0, src[lo * capacity:hi * capacity]) \
        .view(hi - lo, capacity, u)
    h = torch.baddbmm(b1[:, None, :].to(x.dtype), expert_in,
                      w1.transpose(1, 2))                        # (E, C, H)
    h = act(h)
    eo = torch.baddbmm(b2[:, None, :].to(x.dtype), h,
                       w2.transpose(1, 2))                       # (E, C, U)
    # the other ranks' experts' rows read zeros here
    eo_pad = torch.cat([eo.new_zeros(lo * capacity, u),
                        eo.reshape((hi - lo) * capacity, u),
                        eo.new_zeros((e - hi) * capacity + 1, u)])
    y = sum(g.to(x.dtype).float()[:, None] * eo_pad.index_select(0, f)
            .float() for g, f in zip(gates, flat))
    if ep > 1:
        y = _coll.psum(y, mesh, "ep")
    first = _one_hot(experts[0], e, torch.float32)
    if split is None:
        frac, mean_prob = first.mean(0), probs.mean(0)
    else:    # the global means: one all-reduce of both sums
        mesh, axes, (nr, _, ns, _) = split
        both = _coll.batch_sum(torch.cat([first.sum(0), probs.sum(0)]),
                               mesh, axes) / (s * nr * ns)
        frac, mean_prob = both[:e], both[e:]
    aux = e * torch.sum(frac * mean_prob)
    return y.to(x.dtype), aux.float()


_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "silu": torch.nn.functional.silu, "swish": torch.nn.functional.silu,
         "softplus": torch.nn.functional.softplus}


class MoEFFN(HybridBlock):
    """Sparse FFN: top-k gated mixture of ``num_experts`` two-layer MLPs.

    ``forward(x: (..., units)) -> (y: (..., units), aux_loss: scalar)``.
    Parameters as the reference declares them: ``gate_weight (E, U)``,
    ``expert_w1 (E, H, U)``, ``expert_b1 (E, H)`` (zeros),
    ``expert_w2 (E, U, H)``, ``expert_b2 (E, U)`` (zeros), drawn from
    ``generator`` in ``dtype`` on its device."""

    def __init__(self, units, hidden_size, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", dtype=torch.float32,
                 generator=None, prefix=None, params=None):
        super().__init__(prefix, params)
        from ..gluon.block import as_dtype, default_generator
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 (Switch) or 2 (GShard)")
        if activation != "gelu" and activation not in _ACTS:
            raise ValueError(f"MoEFFN: unknown activation {activation!r}")
        self._units, self._hidden = units, hidden_size
        self._E, self._k = num_experts, top_k
        self._cf = float(capacity_factor)
        self._act_name = activation
        g, dt = default_generator(generator), as_dtype(dtype)
        e = num_experts
        self._declare("gate_weight", (e, units), None, dt, g)
        self._declare("expert_w1", (e, hidden_size, units), None, dt, g)
        self._declare("expert_b1", (e, hidden_size), "zeros", dt, g)
        self._declare("expert_w2", (e, units, hidden_size), None, dt, g)
        self._declare("expert_b2", (e, units), "zeros", dt, g)

    def capacity(self, tokens):
        """Slots per expert for ``tokens`` tokens."""
        return max(1, math.ceil(self._cf * tokens * self._k / self._E))

    def forward(self, x):
        shape = x.shape
        s = math.prod(shape[:-1])
        act = ops.gelu if self._act_name == "gelu" else _ACTS[self._act_name]
        split = _coll.token_split()
        if split is None and _coll.batch_split()[2] > 1:
            raise MXNetError(
                "MoEFFN: the step's batch is split over ranks along a "
                "dimension other than its rows and its sequence; routing "
                "the global batch is ported only for row (dp) and "
                "sequence (sp) splits, and routing each rank's tokens "
                "would differ from the reference's mesh program")
        ranks = 1 if split is None else split[2][0] * split[2][2]
        y, aux = _moe_forward(
            x.reshape(s, shape[-1]), self._parameters["gate_weight"],
            self._parameters["expert_w1"], self._parameters["expert_b1"],
            self._parameters["expert_w2"], self._parameters["expert_b2"],
            top_k=self._k, capacity=self.capacity(s * ranks), act=act,
            split=split, rows=shape[0] if x.dim() > 2 else s)
        return y.reshape(shape), aux

    def __repr__(self):
        return (f"MoEFFN(units={self._units}, hidden={self._hidden}, "
                f"experts={self._E}, top_k={self._k}, "
                f"capacity_factor={self._cf})")
