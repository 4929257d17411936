"""BERT for pretraining, from ``tpu_mx/models/bert.py``.

The encoder and the tied-embedding MLM head as :class:`torch.nn.Module`s
with the reference's parameter names, shapes and order (so
:meth:`BERTModel.from_numpy` can carry the reference's weights over),
and its numerics in bfloat16: LayerNorm statistics in float32, attention
scores and softmax statistics in float32 (inside the flash kernels), and
MLM logits as the float32 accumulator of the head's product.

Attention goes through ``parallel.attention``: the flash kernels on the
card — in training with their in-kernel dropout, and with ``kv_valid``
whenever ``valid_length`` is given — and the dense plain version on the
CPU.  Every random draw (parameter init, hidden dropout, the attention
dropout seed) comes from the model's explicit ``torch.Generator``.

``moe_every=N`` makes every N-th layer a :class:`MoETransformerLayer`
(the FFN a :class:`~tpu_mx_torch.parallel.moe.MoEFFN`), and the forward
then returns ``(logits, aux)``; ``remat=True`` recomputes each
transformer layer in the backward (``HybridBlock.remat``, with
``remat_policy`` a name of ``jax.checkpoint_policies``).

On a mesh (``parallel.make_mesh``; the sharding rules and data specs are
the reference's, over the port's ``P``), inside the train step's SPMD
region the layers split their work as the reference's rules lay the
weights out: over ``tp`` (Megatron) a rank computes its ``H/tp`` heads —
the ``qkv`` rows of its heads, the ``attnout`` columns of its heads, its
``ffn1`` rows and ``ffn2`` columns (``collectives.take``), the
replicated input entering by ``copy_to`` and the partial outputs summed
by ``psum`` before the biases.  This is Megatron's split of the compute,
not of the weights: every rank holds each weight whole, and ``take``'s
backward all-reduces a whole-size gradient over ``tp``, so tp saves no
weight or gradient memory and moves the weights' size a step (Megatron
keeps the rank's block and needs no gradient collective; ROADMAP A item
9b).  Over ``sp`` a rank holds ``T/sp``
positions, reads its slice of the position embeddings, and attends by
ring or Ulysses attention (``parallel.attention``).  Outside a region
the model computes the whole function on whole tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import device as _device
from .. import random as _random
from ..base import MXNetError
from ..gluon import loss as _loss
from ..gluon.block import (HybridBlock, as_dtype, load_numpy,
                           resolve_remat_policy)
from ..gluon.nn import Dense, Dropout, LayerNorm
from ..ndarray import ops
from ..parallel import attention as _attention
from ..parallel import collectives as _coll
from ..parallel.mesh import P
from ..parallel.moe import MoEFFN

__all__ = ["BERTModel", "BERTEncoder", "TransformerLayer",
           "MoETransformerLayer", "SelfAttention", "MLMLoss",
           "bert_base_config", "bert_sharding_rules", "bert_data_specs"]


def bert_base_config(vocab_size=30522, max_len=512):
    return dict(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                vocab_size=vocab_size, max_length=max_len, dropout=0.1)


def bert_sharding_rules():
    """Megatron TP layout (regex → PartitionSpec on (out, in) weights):
    column-parallel for qkv & FFN-in, row-parallel for the output mats."""
    return [
        (r"qkv_weight$", P("tp", None)),
        (r"qkv_bias$", P("tp")),
        (r"attnout_weight$", P(None, "tp")),
        (r"ffn1_weight$", P("tp", None)),
        (r"ffn1_bias$", P("tp")),
        (r"ffn2_weight$", P(None, "tp")),
        (r"word_embed_weight$", P(None, None)),
        # everything else (embeddings, LN, heads) replicated
    ]


def bert_data_specs():
    """(tokens, token_types, labels) enter sharded batch×sequence."""
    return (P("dp", "sp"), P("dp", "sp"), P("dp", "sp"))


class SelfAttention(HybridBlock):
    """Fused QKV projection ``(3U, U)``, split ``(B, T, 3, H, D)``, then
    attention over ``(B, H, T, D)`` and the output projection."""

    def __init__(self, units, num_heads, dropout=0.0, mesh=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self._heads, self._dropout, self._mesh = num_heads, dropout, mesh
        self._generator = generator
        g, dt = generator, dtype
        self._declare("qkv_weight", (3 * units, units), None, dt, g)
        self._declare("qkv_bias", (3 * units,), None, dt, g)
        self._declare("attnout_weight", (units, units), None, dt, g)
        self._declare("attnout_bias", (units,), None, dt, g)

    def forward(self, x, valid_length=None):
        b, t, u = x.shape
        mesh, tp, r = _coll.split_over("tp")
        h, d = self._heads // tp, u // self._heads
        wq, bq = self.qkv_weight, self.qkv_bias
        wo = self.attnout_weight
        if tp > 1:
            # this rank's heads: rows [r·h·d, (r+1)·h·d) of each of q, k, v
            # and the same columns of the output projection
            own = torch.arange(r * h * d, (r + 1) * h * d, device=x.device)
            rows = torch.cat([own + i * u for i in range(3)])
            wq = _coll.take(wq, mesh, "tp", 0, rows)
            bq = _coll.take(bq, mesh, "tp", 0, rows)
            wo = _coll.take(wo, mesh, "tp", 1, own)
            x = _coll.copy_to(x, mesh, "tp")
        qkv = ops.FullyConnected(x, wq, bq, flatten=False)      # (B,T,3hd)
        q, k, v = qkv.reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4) \
            .unbind(0)                                           # (B,h,T,D)
        # attention-probability dropout in training only, one seed a call
        rate = self._dropout if self.training else 0.0
        seed = _random.take_seed(self._generator).to(x.device) \
            if rate > 0.0 else None
        out = _attention(q, k, v, mesh=self._mesh, causal=False,
                         valid_length=valid_length, dropout_rate=rate,
                         dropout_seed=seed)
        out = out.transpose(1, 2).reshape(b, t, h * d)
        if tp == 1:
            return ops.FullyConnected(out, wo, self.attnout_bias,
                                      flatten=False)
        part = ops.FullyConnected(out, wo, None, no_bias=True, flatten=False)
        return _coll.psum(part, mesh, "tp") + self.attnout_bias


def _ffn(x, w1, b1, w2, b2):
    """``gelu(x·w1ᵀ + b1)·w2ᵀ + b2``; over ``tp`` a rank takes its block
    of the hidden units (rows of ``w1``/``b1``, columns of ``w2``) and
    the partial products are summed before ``b2`` (Megatron's column-
    then row-parallel pair)."""
    mesh, tp, r = _coll.split_over("tp")
    if tp == 1:
        h = ops.gelu(ops.FullyConnected(x, w1, b1, flatten=False))
        return ops.FullyConnected(h, w2, b2, flatten=False)
    n = w1.shape[0] // tp
    own = torch.arange(r * n, (r + 1) * n, device=x.device)
    x = _coll.copy_to(x, mesh, "tp")
    h = ops.gelu(ops.FullyConnected(x, _coll.take(w1, mesh, "tp", 0, own),
                                    _coll.take(b1, mesh, "tp", 0, own),
                                    flatten=False))
    part = ops.FullyConnected(h, _coll.take(w2, mesh, "tp", 1, own), None,
                              no_bias=True, flatten=False)
    return _coll.psum(part, mesh, "tp") + b2


class TransformerLayer(HybridBlock):
    """Post-LN encoder layer: attention, dropout, residual + LayerNorm,
    FFN with gelu, dropout, residual + LayerNorm."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 mesh=None, dtype=torch.float32, generator=None):
        super().__init__()
        g, dt = generator, dtype
        # own parameters first, then the children: the reference's order
        self._declare("ffn1_weight", (hidden_size, units), None, dt, g)
        self._declare("ffn1_bias", (hidden_size,), None, dt, g)
        self._declare("ffn2_weight", (units, hidden_size), None, dt, g)
        self._declare("ffn2_bias", (units,), None, dt, g)
        self.attention = SelfAttention(units, num_heads, dropout, mesh, dt, g)
        self.ln1 = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.ln2 = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.dropout = Dropout(dropout, g) if dropout else None

    def forward(self, x, valid_length=None):
        att = self.attention(x, valid_length)
        if self.dropout is not None:
            att = self.dropout(att)
        x = self.ln1(x + att)
        h = _ffn(x, self.ffn1_weight, self.ffn1_bias, self.ffn2_weight,
                 self.ffn2_bias)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h)


class MoETransformerLayer(HybridBlock):
    """:class:`TransformerLayer` with the dense FFN swapped for a sparse
    :class:`~tpu_mx_torch.parallel.moe.MoEFFN`; ``forward`` returns
    ``(x_out, aux_loss)``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 mesh=None, num_experts=8, top_k=2, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g, dt = generator, dtype
        self.attention = SelfAttention(units, num_heads, dropout, mesh, dt, g)
        self.ln1 = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.ln2 = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.dropout = Dropout(dropout, g) if dropout else None
        self.moe = MoEFFN(units, hidden_size, num_experts, top_k=top_k,
                          dtype=dt, generator=g)

    def forward(self, x, valid_length=None):
        att = self.attention(x, valid_length)
        if self.dropout is not None:
            att = self.dropout(att)
        x = self.ln1(x + att)
        h, aux = self.moe(x)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h), aux


class BERTEncoder(HybridBlock):
    """Word + token-type + position embeddings, LayerNorm, dropout, and
    ``num_layers`` transformer layers; with ``moe_every=N`` layers N-1,
    2N-1, ... are :class:`MoETransformerLayer`s and the forward returns
    ``(x, aux)``, ``aux`` the sum of their load-balance terms."""

    def __init__(self, num_layers, units, hidden_size, num_heads, vocab_size,
                 max_length, dropout=0.0, mesh=None, dtype=torch.float32,
                 moe_every=0, moe_experts=8, moe_top_k=2, generator=None):
        super().__init__()
        g, dt = generator, dtype
        self._declare("word_embed_weight", (vocab_size, units), None, dt, g)
        self._declare("pos_embed_weight", (max_length, units), None, dt, g)
        self._declare("type_embed_weight", (2, units), None, dt, g)
        self.ln = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.dropout = Dropout(dropout, g) if dropout else None
        self._moe = bool(moe_every)
        layers = []
        for i in range(num_layers):
            # moe_every=2 -> layers 1, 3, 5, ... are sparse
            if moe_every and (i % moe_every) == moe_every - 1:
                layers.append(MoETransformerLayer(
                    units, hidden_size, num_heads, dropout, mesh,
                    num_experts=moe_experts, top_k=moe_top_k, dtype=dt,
                    generator=g))
            else:
                layers.append(TransformerLayer(units, hidden_size, num_heads,
                                               dropout, mesh, dt, g))
        if moe_every and not any(isinstance(m, MoETransformerLayer)
                                 for m in layers):
            raise ValueError(
                f"moe_every={moe_every} places no MoE layer in "
                f"{num_layers} layers (needs moe_every <= num_layers)")
        self.layers = nn.ModuleList(layers)

    def forward(self, tokens, token_types, valid_length=None):
        t = tokens.shape[1]
        # over sp a rank holds positions [i·t, (i+1)·t)
        _, _, sp_index = _coll.split_over("sp")
        x = ops.Embedding(tokens, self.word_embed_weight)
        x = x + ops.Embedding(token_types, self.type_embed_weight)
        x = x + self.pos_embed_weight[sp_index * t:(sp_index + 1) * t][None]
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        aux_total = None
        for layer in self.layers:
            if isinstance(layer, MoETransformerLayer):
                x, aux = layer(x, valid_length)
                aux_total = aux if aux_total is None else aux_total + aux
            else:
                x = layer(x, valid_length)
        return (x, aux_total) if self._moe else x


class BERTModel(HybridBlock):
    """Encoder + tied-embedding MLM head (the pretraining objective).

    ``BERTModel(config, dtype="bfloat16", device=None, generator=g)``:
    every parameter in ``dtype`` on ``device``, drawn from ``g`` (default:
    ``random.generator(device)``), which also draws the dropout masks
    and seeds.  ``forward(tokens, token_types, valid_length=None,
    masked_positions=None)`` returns float32 logits ``(B, M, V)`` over
    the masked positions (``(B, T, V)`` without them); with
    ``moe_every`` it returns ``(logits, aux_loss)`` (add ``aux_weight ·
    aux_loss`` to the objective).  ``remat=True`` recomputes each
    transformer layer in the backward; ``remat_policy`` (a name of
    ``jax.checkpoint_policies``) keeps some of its outputs."""

    def __init__(self, config=None, mesh=None, dtype="float32", remat=False,
                 remat_policy=None, moe_every=0, moe_experts=8, moe_top_k=2,
                 device=None, generator=None):
        super().__init__()
        # resolve up front: a typo'd policy (or one passed with remat off)
        # fails at construction, as in the reference
        policy = resolve_remat_policy(remat_policy)
        if remat_policy is not None and not remat:
            raise ValueError("remat_policy given but remat=False — pass "
                             "remat=True (or drop the policy)")
        cfg = dict(config or bert_base_config())
        dev = _device.resolve(device)
        gen = _random.generator(dev) if generator is None else generator
        if gen.device.type != dev.type:
            raise MXNetError(f"BERTModel(device={str(device)!r}): the "
                             f"generator lives on {gen.device}")
        dt = as_dtype(dtype)
        self._cfg = cfg
        self._moe = bool(moe_every)
        units = cfg["units"]
        self._declare("mlm_bias", (cfg["vocab_size"],), None, dt, gen)
        self.encoder = BERTEncoder(mesh=mesh, dtype=dt, moe_every=moe_every,
                                   moe_experts=moe_experts,
                                   moe_top_k=moe_top_k, generator=gen, **cfg)
        if remat:
            for layer in self.encoder.layers:
                layer.remat(policy=policy)
        self.mlm_dense = Dense(units, flatten=False, in_units=units, dtype=dt,
                               generator=gen)
        self.mlm_ln = LayerNorm(in_channels=units, dtype=dt, generator=gen)

    def forward(self, tokens, token_types, valid_length=None,
                masked_positions=None):
        aux = None
        if self._moe:
            x, aux = self.encoder(tokens, token_types, valid_length)
        else:
            x = self.encoder(tokens, token_types, valid_length)
        if masked_positions is not None:
            if _coll.split_over("sp")[1] > 1:
                raise ValueError("BERTModel: masked_positions index the "
                                 "whole sequence; over an sp axis pass "
                                 "None and label every position")
            # project ONLY the masked positions through the vocab head
            idx = masked_positions.long()[..., None].expand(-1, -1,
                                                            x.shape[-1])
            x = torch.gather(x, 1, idx)                          # (B,M,U)
        h = self.mlm_ln(ops.gelu(self.mlm_dense(x)))
        # tied decoder, logits in float32: the float32 accumulator of the
        # product (both operands upcast, which is exact), not a cast of a
        # bfloat16 result
        embed = self.encoder.word_embed_weight
        logits = torch.matmul(h.float(), embed.float().t()) \
            + self.mlm_bias.float()
        return (logits, aux) if self._moe else logits

    @classmethod
    def from_numpy(cls, params, config=None, dtype="float32", device=None,
                   generator=None, **kwargs):
        """The port's model computing the reference's function: ``params``
        maps the reference's ``collect_params()`` names to numpy arrays, in
        that (structural) order.  Reference names carry per-instance
        prefixes (``selfattention3_qkv_weight``), so the i-th array goes
        to the port's i-th parameter, after checking that its name ends in
        the port parameter's name and that the shapes agree: every array
        is consumed once and every parameter is set
        (``gluon.block.load_numpy``).  ``kwargs`` are the constructor's
        (``moe_every``, ``moe_experts``, ``moe_top_k``, ``remat``,
        ``remat_policy``): the experts' parameters follow each MoE
        layer's attention and LayerNorms, as in the reference."""
        return load_numpy(cls(config, dtype=dtype, device=device,
                              generator=generator, **kwargs), params)


class MLMLoss(_loss.Loss):
    """The pretraining loss of the reference's BERT benchmark
    (``bench.py::_bert_once``): softmax cross-entropy over the gathered
    masked positions (every label is a real token id), one value per
    sequence, the mean over its masked positions.  Every sequence has as
    many masked positions, so the mean of these (``CompiledTrainStep``'s
    objective) is the benchmark's loss, and their sum scaled by
    ``1/batch`` (``loss.backward()``, ``Trainer.step(batch)``) too."""

    def __init__(self):
        super().__init__(weight=None, batch_axis=0)
        self._ce = _loss.SoftmaxCrossEntropyLoss()

    def forward(self, logits, labels):
        ce = self._ce(logits.reshape(-1, logits.shape[-1]),
                      labels.reshape(-1))
        return ce.reshape(logits.shape[0], -1).mean(dim=1)
