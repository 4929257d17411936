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

Not ported yet: the MoE layers (``moe_every``, ROADMAP A7), ``remat``
(``torch.utils.checkpoint``, ROADMAP A4) and the sharding rules and
mesh (ROADMAP A16); passing them raises.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import device as _device
from .. import random as _random
from ..base import MXNetError, refuse_unported
from ..gluon import loss as _loss
from ..gluon.block import HybridBlock, as_dtype, load_numpy
from ..gluon.nn import Dense, Dropout, LayerNorm
from ..ndarray import ops
from ..parallel import attention as _attention

__all__ = ["BERTModel", "BERTEncoder", "TransformerLayer", "SelfAttention",
           "MLMLoss", "bert_base_config"]


def bert_base_config(vocab_size=30522, max_len=512):
    return dict(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                vocab_size=vocab_size, max_length=max_len, dropout=0.1)


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
        h = self._heads
        qkv = ops.FullyConnected(x, self.qkv_weight, self.qkv_bias,
                                 flatten=False)               # (B,T,3U)
        q, k, v = qkv.reshape(b, t, 3, h, u // h).permute(2, 0, 3, 1, 4) \
            .unbind(0)                                           # (B,H,T,D)
        # attention-probability dropout in training only, one seed a call
        rate = self._dropout if self.training else 0.0
        seed = _random.take_seed(self._generator) if rate > 0.0 else None
        out = _attention(q, k, v, mesh=self._mesh, causal=False,
                         valid_length=valid_length, dropout_rate=rate,
                         dropout_seed=seed)
        out = out.transpose(1, 2).reshape(b, t, u)
        return ops.FullyConnected(out, self.attnout_weight, self.attnout_bias,
                                  flatten=False)


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
        h = ops.gelu(ops.FullyConnected(x, self.ffn1_weight, self.ffn1_bias,
                                        flatten=False))
        h = ops.FullyConnected(h, self.ffn2_weight, self.ffn2_bias,
                               flatten=False)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h)


class BERTEncoder(HybridBlock):
    """Word + token-type + position embeddings, LayerNorm, dropout, and
    ``num_layers`` transformer layers."""

    def __init__(self, num_layers, units, hidden_size, num_heads, vocab_size,
                 max_length, dropout=0.0, mesh=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g, dt = generator, dtype
        self._declare("word_embed_weight", (vocab_size, units), None, dt, g)
        self._declare("pos_embed_weight", (max_length, units), None, dt, g)
        self._declare("type_embed_weight", (2, units), None, dt, g)
        self.ln = LayerNorm(in_channels=units, dtype=dt, generator=g)
        self.dropout = Dropout(dropout, g) if dropout else None
        self.layers = nn.ModuleList(
            TransformerLayer(units, hidden_size, num_heads, dropout, mesh, dt,
                             g) for _ in range(num_layers))

    def forward(self, tokens, token_types, valid_length=None):
        t = tokens.shape[1]
        x = ops.Embedding(tokens, self.word_embed_weight)
        x = x + ops.Embedding(token_types, self.type_embed_weight)
        x = x + self.pos_embed_weight[:t][None]
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        for layer in self.layers:
            x = layer(x, valid_length)
        return x


class BERTModel(HybridBlock):
    """Encoder + tied-embedding MLM head (the pretraining objective).

    ``BERTModel(config, dtype="bfloat16", device="cuda", generator=g)``:
    every parameter in ``dtype`` on ``device``, drawn from ``g`` (default:
    ``random.generator(device)``), which also draws the dropout masks
    and seeds.  ``forward(tokens, token_types, valid_length=None,
    masked_positions=None)`` returns float32 logits ``(B, M, V)`` over
    the masked positions (``(B, T, V)`` without them)."""

    def __init__(self, config=None, mesh=None, dtype="float32", remat=False,
                 remat_policy=None, moe_every=0, moe_experts=8, moe_top_k=2,
                 device="cuda", generator=None):
        super().__init__()
        if moe_every:
            raise MXNetError("BERTModel: the MoE layers (moe_every) are not "
                             "ported yet (ROADMAP A7)")
        refuse_unported("BERTModel", "A7", moe_experts=(moe_experts, 8),
                        moe_top_k=(moe_top_k, 2))
        if remat or remat_policy is not None:
            raise MXNetError("BERTModel: remat is not ported yet (ROADMAP "
                             "A4: torch.utils.checkpoint)")
        if mesh is not None:
            raise MXNetError("BERTModel: the mesh and sharding rules are not "
                             "ported yet (ROADMAP A16)")
        cfg = dict(config or bert_base_config())
        dev = _device.resolve(device)
        gen = _random.generator(dev) if generator is None else generator
        if gen.device.type != dev.type:
            raise MXNetError(f"BERTModel(device={str(device)!r}): the "
                             f"generator lives on {gen.device}")
        dt = as_dtype(dtype)
        self._cfg = cfg
        units = cfg["units"]
        self._declare("mlm_bias", (cfg["vocab_size"],), None, dt, gen)
        self.encoder = BERTEncoder(dtype=dt, generator=gen, **cfg)
        self.mlm_dense = Dense(units, flatten=False, in_units=units, dtype=dt,
                               generator=gen)
        self.mlm_ln = LayerNorm(in_channels=units, dtype=dt, generator=gen)

    def forward(self, tokens, token_types, valid_length=None,
                masked_positions=None):
        x = self.encoder(tokens, token_types, valid_length)
        if masked_positions is not None:
            # project ONLY the masked positions through the vocab head
            idx = masked_positions.long()[..., None].expand(-1, -1,
                                                            x.shape[-1])
            x = torch.gather(x, 1, idx)                          # (B,M,U)
        h = self.mlm_ln(ops.gelu(self.mlm_dense(x)))
        # tied decoder, logits in float32: the float32 accumulator of the
        # product (both operands upcast, which is exact), not a cast of a
        # bfloat16 result
        embed = self.encoder.word_embed_weight
        return torch.matmul(h.float(), embed.float().t()) \
            + self.mlm_bias.float()

    @classmethod
    def from_numpy(cls, params, config=None, dtype="float32", device="cuda",
                   generator=None):
        """The port's model computing the reference's function: ``params``
        maps the reference's ``collect_params()`` names to numpy arrays, in
        that (structural) order.  Reference names carry per-instance
        prefixes (``selfattention3_qkv_weight``), so the i-th array goes
        to the port's i-th parameter, after checking that its name ends in
        the port parameter's name and that the shapes agree: every array
        is consumed once and every parameter is set
        (``gluon.block.load_numpy``)."""
        return load_numpy(cls(config, dtype=dtype, device=device,
                              generator=generator), params)


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
