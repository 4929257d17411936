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
"""
from __future__ import annotations

import math

import torch

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


def moe_route(probs, top_k, capacity):
    """The reference's routing of ``probs`` ``(S, E)`` (float32): per
    round ``r < top_k``, each token's expert ``experts[r]`` (int64,
    ``(S,)``), its slot in that expert ``slots[r]`` (int32 position
    count, first choices before second), whether the slot is within
    capacity ``kept[r]``, and its gate ``gates[r]`` (differentiable in
    ``probs``; renormalised over the picks for ``top_k > 1``)."""
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
        pos = run - onehot - start + prev[:, None]               # (E, S)
        slot = pos.gather(0, idx[None, :])[0]
        slots.append(slot)
        kept.append(slot < capacity)
        prev = prev + run[:, -1] - start[:, 0]
    return experts, slots, kept, gates


def _moe_forward(x, gw, w1, b1, w2, b2, *, top_k, capacity, act):
    """Routing and expert compute on flattened tokens ``(S, U)``; returns
    ``(y, aux)``, ``y`` in ``x``'s dtype and ``aux`` float32.  Over
    ``ep`` (module docstring) the rank's experts run and the outputs
    are summed over the axis."""
    s, u = x.shape
    e = gw.shape[0]
    probs = torch.softmax(x.float() @ gw.float().t(), dim=-1)   # (S, E)
    experts, slots, kept, gates = moe_route(probs, top_k, capacity)
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
    frac = _one_hot(experts[0], e, torch.float32).mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
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
        y, aux = _moe_forward(
            x.reshape(s, shape[-1]), self._parameters["gate_weight"],
            self._parameters["expert_w1"], self._parameters["expert_b1"],
            self._parameters["expert_w2"], self._parameters["expert_b2"],
            top_k=self._k, capacity=self.capacity(s), act=act)
        return y.reshape(shape), aux

    def __repr__(self):
        return (f"MoEFFN(units={self._units}, hidden={self._hidden}, "
                f"experts={self._E}, top_k={self._k}, "
                f"capacity_factor={self._cf})")
