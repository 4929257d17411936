"""TinyLM: the deterministic attention decoder the serving runtime drives.

The port of ``tpu_mx/serving/model.py`` (weights and forward) and of the
whole-step decode of ``tpu_mx/serving/jax_model.py``.  TinyLM is a
multi-layer attention decoder with seed-deterministic random weights,
positional embeddings, residual connections and a bounded ``tanh``; it
is not a trained model but the workload that makes the serving claims
checkable.  Its constructor draws the **same** ``numpy.random.
RandomState`` sequence as the reference, so one seed gives the same
weights in both packages, and :meth:`TinyLM.from_numpy` carries the
reference's weights over as they are.

The weights are registered buffers on the model's device (``device=``,
default ``"cuda"``), float32 throughout as the reference serves.  Two
entry points run the model:

- :meth:`TinyLM.prefill` — a whole prompt; returns every layer's K/V for
  the cache bulk-fill and the last position's logits.  Attention goes
  through the flash forward (``serving/attention.py``).
- :meth:`TinyLM.prefill_suffix` — the tail of a prompt whose leading
  positions' K/V come from a shared prefix in the cache.
- :meth:`TinyLM.decode_step` — the engine's fused arm: one decode step
  for a batch with the whole step on the device: token ids in (a
  speculative window's drafts made on the device too), embed, then per
  layer the QKV projections, the K/V write into the cache pool
  (``index_put_``), the paged kernel over the ``(B, K)`` window and the
  residual combine, then logits and greedy argmax.  One host-to-device
  copy carries the step's integer operands in and one device-to-host
  copy brings the greedy ids, the drafts, the health scalar and (for
  sampled rows) the last position's logits back.
- :meth:`TinyLM.embed`, :meth:`TinyLM.layer_qkv`,
  :meth:`TinyLM.layer_combine` and :meth:`TinyLM.logits` — the pieces
  the engine's host layer loop interleaves with the cache's per-layer
  writes and decode attention, as the reference's numpy model offers
  them; each runs on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device
from . import attention as _attn

__all__ = ["TinyLM"]


class TinyLM(nn.Module):
    """Seed-deterministic attention decoder (see module docstring)."""

    def __init__(self, vocab_size=128, embed_dim=64, num_heads=4,
                 num_layers=2, max_positions=4096, seed=0, device="cuda"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must divide by "
                             f"num_heads {num_heads}")
        dev = _device.resolve(device)
        # the reference's draw order, one matrix at a time: each lands on
        # the device before the next is drawn, so a wide model never holds
        # two float64 copies of its weights on the host
        rng = np.random.RandomState(seed)
        scale = 1.0 / np.sqrt(embed_dim)

        def mat(*shape):
            return torch.from_numpy(
                (rng.standard_normal(shape) * scale).astype(np.float32)
            ).to(dev)

        tok_emb = mat(vocab_size, embed_dim)
        pos_emb = mat(max_positions, embed_dim)
        layers = [{"wq": mat(embed_dim, embed_dim),
                   "wk": mat(embed_dim, embed_dim),
                   "wv": mat(embed_dim, embed_dim),
                   "wo": mat(embed_dim, embed_dim)}
                  for _ in range(num_layers)]
        w_out = mat(embed_dim, vocab_size)
        self._install(tok_emb, pos_emb, layers, w_out, num_heads, dev)

    @classmethod
    def from_numpy(cls, tok_emb, pos_emb, layers, w_out, *, num_heads,
                   device="cuda"):
        """A TinyLM holding the given weights: ``tok_emb`` ``(V, E)``,
        ``pos_emb`` ``(P, E)``, ``layers`` a list of ``{"wq", "wk", "wv",
        "wo"}`` ``(E, E)`` matrices and ``w_out`` ``(E, V)`` — the
        reference TinyLM's attributes of the same names.  The sizes are
        read off the arrays."""
        dev = _device.resolve(device)
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        model._install(put(tok_emb), put(pos_emb),
                       [{n: put(lay[n]) for n in ("wq", "wk", "wv", "wo")}
                        for lay in layers], put(w_out), num_heads, dev)
        return model

    def _install(self, tok_emb, pos_emb, layers, w_out, num_heads, dev):
        self.vocab_size, self.embed_dim = tok_emb.shape
        self.max_positions = pos_emb.shape[0]
        self.num_heads = int(num_heads)
        if self.embed_dim % self.num_heads:
            raise ValueError(f"embed_dim {self.embed_dim} must divide by "
                             f"num_heads {self.num_heads}")
        self.head_dim = self.embed_dim // self.num_heads
        self.num_layers = len(layers)
        self.device = dev
        self.register_buffer("tok_emb", tok_emb)
        self.register_buffer("pos_emb", pos_emb)
        for name in ("wq", "wk", "wv", "wo"):
            # (layers, E, E): one buffer per projection, indexed per layer
            self.register_buffer(name, torch.stack([l[name] for l in layers]))
        self.register_buffer("w_out", w_out)

    def to_numpy(self):
        """The weights as the reference's numpy attributes: ``(tok_emb,
        pos_emb, layers, w_out)`` — :meth:`from_numpy`'s arguments."""
        host = lambda t: t.detach().cpu().numpy()
        layers = [{n: host(getattr(self, n)[i])
                   for n in ("wq", "wk", "wv", "wo")}
                  for i in range(self.num_layers)]
        return host(self.tok_emb), host(self.pos_emb), layers, \
            host(self.w_out)

    # -- shared projections ---------------------------------------------------
    def _check_positions(self, top):
        if top >= self.max_positions:
            raise ValueError(
                f"position {top} >= max_positions={self.max_positions} — "
                "raise max_positions or cap prompt+generation length at "
                "admission")

    def _heads(self, x):
        # (..., E) -> (..., H, D)
        return x.reshape(x.shape[:-1] + (self.num_heads, self.head_dim))

    def _embed(self, tokens, positions):
        return self.tok_emb[tokens % self.vocab_size] + self.pos_emb[positions]

    # -- the layer pieces (the host layer loop's, and every forward's) -------
    # the weights are buffers, so nothing here records a graph
    def embed(self, tokens, positions):
        """``(B,)`` token ids at ``(B,)`` absolute positions -> ``(B, E)``
        on the device.  Host ids cross in one copy; a device tensor of
        ids stays where it is."""
        positions = np.asarray(positions, np.int64).reshape(-1)
        if positions.size:
            self._check_positions(int(positions.max()))
        if isinstance(tokens, torch.Tensor):
            tok = tokens.to(self.device).long().reshape(-1)
            pos = torch.from_numpy(positions).to(self.device)
        else:
            ops = torch.from_numpy(np.concatenate(
                [np.asarray(tokens, np.int64).reshape(-1), positions]))
            tok, pos = ops.to(self.device).view(2, -1)
        return self._embed(tok, pos)

    def layer_qkv(self, i, h):
        """``(B, E)`` -> ``q, k, v``, each ``(B, H, D)``."""
        return (self._heads(h @ self.wq[i]), self._heads(h @ self.wk[i]),
                self._heads(h @ self.wv[i]))

    def layer_combine(self, i, h, attn):
        """Residual + output projection + bounded nonlinearity of layer
        ``i`` (``tanh`` keeps untrained-weight generations finite, so the
        engine's NaN check fires on real faults only)."""
        flat = attn.reshape(attn.shape[0], self.embed_dim)
        return torch.tanh(h + flat @ self.wo[i])

    def logits(self, h):
        """``(B, E)`` -> ``(B, V)``."""
        return h @ self.w_out

    def step_result(self, logits, drafts, b, k, want_logits):
        """A decode step's results on the host in one device-to-host copy:
        int64 ``(B, K)`` greedy ids of the ``(B*K, V)`` ``logits``, int64
        ``(B, K-1)`` drafts, the max |logit| and, with ``want_logits``,
        the float32 ``(B, V)`` logits of each row's last window position
        (else None).  The ids travel as float32, exact for any vocabulary
        below 2**24."""
        parts = [logits.argmax(dim=-1).float(), drafts.reshape(-1).float(),
                 logits.abs().amax().reshape(1)]
        if want_logits:
            parts.append(logits.view(b, k, -1)[:, -1].reshape(-1))
        back = torch.cat(parts).cpu().numpy()
        n = b * k + b * (k - 1)
        out = back[:b * k].astype(np.int64).reshape(b, k)
        drafted = back[b * k:n].astype(np.int64).reshape(b, k - 1)
        last = back[n + 1:].reshape(b, -1) if want_logits else None
        return out, drafted, float(back[n]), last

    # -- prefill --------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens):
        """The whole prompt in one call.  ``tokens``: host ints ``(L,)``.
        Returns ``(k, v, logits_last)`` on the device: ``k``/``v``
        ``(num_layers, L, H, D)`` — the cache bulk-fill — and the last
        position's ``(V,)`` logits."""
        tokens = np.asarray(tokens, np.int64)
        length = tokens.shape[0]
        self._check_positions(length - 1)
        h = self._embed(torch.as_tensor(tokens, device=self.device),
                        torch.arange(length, device=self.device))
        ks, vs = [], []
        for i in range(self.num_layers):
            q, k, v = self.layer_qkv(i, h)                  # (L, H, D)
            ks.append(k)
            vs.append(v)
            h = self.layer_combine(i, h, _attn.prefill_attention(q, k, v))
        return torch.stack(ks), torch.stack(vs), (h[-1:] @ self.w_out)[0]

    @torch.no_grad()
    def prefill_suffix(self, tokens, pos_offset, k_prefix, v_prefix):
        """The tail of a prompt whose leading ``pos_offset`` positions'
        K/V are cached (a shared prefix): ``tokens`` are the suffix's
        host ids at positions ``pos_offset .. pos_offset+S-1``, and
        ``k_prefix``/``v_prefix`` the cached ``(num_layers, pos_offset,
        H, D)`` tensors (``PagedKVCache.gather_plan``).  Returns ``(k, v,
        logits_last)`` as :meth:`prefill` does, for the suffix positions
        only.  Each suffix query attends causally over prefix ++ suffix:
        the rows a full prefill computes for those positions."""
        tokens = np.asarray(tokens, np.int64)
        s = tokens.shape[0]
        if s < 1:
            raise ValueError("prefill_suffix: empty suffix — at least the "
                             "final prompt position must be computed for "
                             "its logits")
        m = int(pos_offset)
        want = (self.num_layers, m, self.num_heads, self.head_dim)
        if tuple(k_prefix.shape) != want or tuple(v_prefix.shape) != want:
            raise ValueError(
                f"prefill_suffix: prefix K/V must be {want}, got "
                f"{tuple(k_prefix.shape)} / {tuple(v_prefix.shape)}")
        self._check_positions(m + s - 1)
        h = self._embed(torch.as_tensor(tokens, device=self.device),
                        torch.arange(m, m + s, device=self.device))
        ks, vs = [], []
        for i in range(self.num_layers):
            q, k, v = self.layer_qkv(i, h)                  # (S, H, D)
            ks.append(k)
            vs.append(v)
            attn = _attn.prefill_attention(q, torch.cat([k_prefix[i], k]),
                                           torch.cat([v_prefix[i], v]))
            h = self.layer_combine(i, h, attn)
        return torch.stack(ks), torch.stack(vs), (h[-1:] @ self.w_out)[0]

    # -- decode ---------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache, tokens, positions, tables, lengths, bids,
                    offs, proposer=None, want_logits=False, kind="paged"):
        """ONE decode step for a batch, on the device, over a window of
        ``K`` positions per row (``K = bids.shape[1]``; 1 without
        speculation).

        ``tokens``/``positions``: host ints ``(B,)`` — each row's stream
        head and its position; ``bids``/``offs``: host ints ``(B, K)`` —
        the pool slots of the window's positions
        (``cache.window_slots``); ``tables``/``lengths``: the batch's
        ``cache.batch_tables``, the window reserved.  With ``K > 1``,
        ``proposer.draft`` drafts each row's next ``K-1`` tokens on the
        device and the window is the head followed by the drafts.  Every
        layer writes the window's K/V into ``cache``'s pools and runs the
        paged kernel once on a ``(B, K, H, D)`` query (``kind`` is the
        engine's decode arm, ``"paged"`` or ``"paged-kernel"``:
        ``serving.attention``).

        Returns ``(out, drafts, health, logits)`` on the host: int64
        ``(B, K)`` greedy ids (``out[:, j]`` follows window position
        ``j``), int64 ``(B, K-1)`` drafts, the step's max |logit|, and
        with ``want_logits`` the float32 ``(B, V)`` logits of the last
        window position (else None) — all in one device-to-host copy."""
        b, k = np.shape(bids)
        tables = np.asarray(tables, np.int64)
        positions = np.asarray(positions, np.int64)
        self._check_positions(int(np.max(positions)) + k - 1)
        # one host->device copy for all of the step's integer operands
        ops = torch.from_numpy(np.concatenate([
            np.asarray(tokens, np.int64), positions,
            np.asarray(lengths, np.int64),
            np.asarray(bids, np.int64).reshape(-1),
            np.asarray(offs, np.int64).reshape(-1),
            tables.reshape(-1)])).to(self.device)
        tok, pos, lens = ops[:3 * b].view(3, b)
        bid, off = ops[3 * b:(3 + 2 * k) * b].view(2, b * k)
        # the kernel's int32 operands, cast once per step, not per layer
        tab = ops[(3 + 2 * k) * b:].view(tables.shape).to(torch.int32)
        lens = lens.to(torch.int32)
        if k > 1:
            drafts = torch.as_tensor(proposer.draft(tok, pos, k - 1),
                                     device=self.device).long()
            window = torch.cat([tok[:, None], drafts], dim=1)
        else:
            drafts = tok.new_zeros((b, 0))
            window = tok[:, None]
        wpos = pos[:, None] + torch.arange(k, device=self.device)
        h = self._embed(window.reshape(-1), wpos.reshape(-1))    # (B*K, E)
        for i in range(self.num_layers):
            q, kk, vv = self.layer_qkv(i, h)                # (B*K, H, D)
            kp, vp = cache.pool(i)
            kp.index_put_((bid, off), kk.to(kp.dtype))
            vp.index_put_((bid, off), vv.to(vp.dtype))
            qw = q.view(b, k, self.num_heads, self.head_dim) if k > 1 else q
            attn = _attn.decode_on_tables(qw, cache, i, tab, lens, kind)
            h = self.layer_combine(i, h, attn.reshape(b * k, self.num_heads,
                                                 self.head_dim))
        return self.step_result(self.logits(h), drafts, b, k,
                                want_logits)
