"""The request front-end: streams of requests in, batched decode out.

The port of ``tpu_mx/serving/server.py``'s serving loop.
:class:`Server` turns a stream of generation requests into scheduler and
engine work:

- ``submit(prompt, max_new_tokens)`` admits a request (any thread) and
  returns its :class:`~tpu_mx_torch.serving.scheduler.Request` handle,
  or raises :class:`~tpu_mx_torch.serving.scheduler.AdmissionReject`
  with a reason — the bounded-queue backpressure contract;
- ``step()`` runs ONE engine iteration: admit + prefill newly admissible
  requests, decode the running batch one token (or an accepted
  speculative window), evict finished sequences at once.  The caller
  drives the loop (``run_until_idle()``), which keeps the data plane
  single-threaded and deterministic;
- ``stream(prompt, ...)`` submits and yields tokens as they are
  generated, driving ``step()`` underneath.

Decoding is greedy, or top-k (``sampling="top_k:K"``): each request then
gets its own sampler seeded by ``fold_seed(sampling_seed, request id)``
(``serving/sampling.py``), and the engine hands each step's last-position
logits back for this thread to sample.  Prefix sharing
(``prefix_sharing``, default ``TPUMX_PREFIX_SHARING``) and speculative
decoding (``TPUMX_SPECULATIVE``) are the engine's.

Not yet ported (ROADMAP): the watchdog and classified-restart ladder, the
committed-token journal and ``recover()``, SLO monitoring, drain and
handoff, and the capacity gauges.  An engine fault
(:class:`NumericDivergence`, a CUDA error) propagates to the caller
after the step's unstarted admissions are put back in the queue.
"""
from __future__ import annotations

import time

import torch

from ..base import MXNetError, refuse_unported
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .engine import EngineCore
from .kv_cache import CacheExhausted
from .sampling import fold_seed, make_sampler, parse_sampling
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["Server"]


class Server:
    """See module docstring.

    ``model`` is a :class:`~tpu_mx_torch.serving.model.TinyLM` on
    ``device`` (default ``"cuda"``; the two must agree).  ``scheduler``
    defaults to a :class:`ContinuousBatchingScheduler` built from
    ``max_pending``/``max_batch``/``max_tokens``/``tenants``;
    ``block_size``/``num_blocks``/``dtype`` size the paged cache;
    ``eos_id`` optionally ends generation early.  ``sampling`` is
    ``"greedy"`` or ``"top_k:K"``, seeded per request from
    ``sampling_seed``; ``prefix_sharing`` (None:
    ``TPUMX_PREFIX_SHARING``) shares the cached K/V of common prompt
    prefixes.  The reference's supervisor, black box, SLO, journal and
    replay arguments are accepted and must keep their defaults: they are
    not ported yet (ROADMAP A10/A12)."""

    def __init__(self, model, *, scheduler=None, max_pending=64,
                 max_batch=8, max_tokens=8192, block_size=16,
                 num_blocks=256, deadline=None, max_restarts=3,
                 backoff=0.05, blackbox=None, eos_id=None, slo=None,
                 tenants=None, prefix_sharing=None, dtype=torch.float32,
                 journal=None, sampling="greedy", sampling_seed=0,
                 replay=None, device="cuda"):
        refuse_unported(
            "Server", "A10/A12", deadline=(deadline, None),
            max_restarts=(max_restarts, 3), backoff=(backoff, 0.05),
            blackbox=(blackbox, None), slo=(slo, None),
            journal=(journal, None), replay=(replay, None))
        dev = _device.resolve(device)
        if model.device.type != dev.type:
            raise MXNetError(f"Server(device={str(device)!r}): the model's "
                             f"weights are on {model.device}")
        self._sampling_kind, self._sampling_k = parse_sampling(sampling)
        self._sampling_seed = int(sampling_seed)
        self.model = model
        self.device = dev
        self.scheduler = scheduler if scheduler is not None else \
            ContinuousBatchingScheduler(max_pending=max_pending,
                                        max_batch=max_batch,
                                        max_tokens=max_tokens,
                                        tenants=tenants)
        self.engine = EngineCore(model, block_size=block_size,
                                 num_blocks=num_blocks, dtype=dtype,
                                 share_prefix=prefix_sharing,
                                 greedy=self._sampling_kind == "greedy")
        self.eos_id = eos_id
        self._steps = 0
        self._tokens_generated = 0
        self._t_first_work = None

    # -- admission (any thread) ----------------------------------------------
    def submit(self, prompt, max_new_tokens=16, request_id=None,
               tenant=None):
        """Admit one request; returns its handle or raises
        :class:`AdmissionReject` (reason on the exception)."""
        req = Request(prompt, max_new_tokens, request_id=request_id,
                      tenant=tenant)
        req.tenant_weight = self.scheduler.tenants.get(req.tenant).weight
        req.sampler = make_sampler(self._sampling_kind, self._sampling_k,
                                   fold_seed(self._sampling_seed, req.id))
        # a request whose worst case can never fit the pool would
        # preempt-loop forever: reject it at the door
        need = self.engine.cache.blocks_for(req.budget_tokens)
        if need > self.engine.cache.allocator.num_blocks:
            self.scheduler.reject(
                req, "request_too_large",
                f"prompt+max_new needs {need} cache blocks > pool of "
                f"{self.engine.cache.allocator.num_blocks}")
        return self.scheduler.submit(req)

    # -- the engine loop (one driver thread) ---------------------------------
    def step(self):
        """One engine iteration (admit → prefill → decode → evict).
        Returns True when any work was done."""
        self._steps += 1
        _tracing.set_context(step=self._steps)
        worked = False
        admits = self.scheduler.take_prefills()
        for i, req in enumerate(admits):
            if self._t_first_work is None:
                self._t_first_work = time.perf_counter()
            _tracing.set_context(request=req.id)
            req.timeline.mark_prefill_start()
            try:
                first, cached = self.engine.prefill(req)
            except CacheExhausted:
                # backpressure: this admission and the rest of the step's
                # go back to the queue front, and the step falls through
                # to decode, whose progress and evictions free blocks
                req.timeline.mark_prefill_failed()
                for later in admits[i + 1:]:
                    later.timeline.mark_defer()
                self.scheduler.defer(admits[i:])
                break
            except BaseException:
                # an engine fault: no admission of this step may be lost
                self.scheduler.defer(admits[i:])
                raise
            finally:
                _tracing.set_context(request=None)
            req.timeline.mark_prefill_end(cached_tokens=cached)
            self.scheduler.mark_running(req)
            if req.sampler is not None:
                first = req.sampler.sample(first)
            self._commit_token(req, first)
            worked = True
        batch = self.scheduler.decode_batch()
        if batch:
            if self._t_first_work is None:
                self._t_first_work = time.perf_counter()
            items = [(r, r.tokens[-1]) for r in batch]
            t0 = time.perf_counter()
            results, preempted = self.engine.decode(items)
            fresh = 0
            for req in batch:
                tokens = results.get(req.id)
                if tokens is None:
                    continue                    # preempted
                if req.sampler is not None:
                    tokens = [req.sampler.sample(tokens)]
                # a list in stream order (one token, or an accepted
                # speculative window): tokens past an EOS or the length
                # budget were never part of the stream
                for token in tokens:
                    fresh += 1
                    self._commit_token(req, token)
                    if req.done:
                        break
            for req in preempted:
                _tracing.emit("serve.evict", request=req.id,
                              reason="preempted", generated=len(req.tokens))
                self.scheduler.requeue(req)
            _telemetry.counter("serve.decode_steps").inc()
            _tracing.emit("serve.decode", batch=len(items),
                          tokens=fresh, t0=t0, t1=time.perf_counter())
            worked = True
        self._update_gauges()
        return worked

    def _commit_token(self, req, token):
        """Record one generated token and finish/evict when done."""
        req.record_token(token)
        self._tokens_generated += 1
        _telemetry.counter("serve.generated_tokens").inc()
        done_eos = self.eos_id is not None and int(token) == self.eos_id
        if done_eos or len(req.tokens) >= req.max_new_tokens:
            reason = "eos" if done_eos else "length"
            self.scheduler.finish(req, reason)
            self.engine.evict(req)
            _tracing.emit("serve.evict", request=req.id, reason=reason,
                          generated=len(req.tokens))

    def _update_gauges(self):
        _telemetry.gauge("serve.cache_utilization").set(
            self.engine.cache.utilization())
        _telemetry.gauge("serve.queue_depth").set(
            self.scheduler.queue_depth())
        if self._t_first_work is not None:
            dt = time.perf_counter() - self._t_first_work
            if dt > 0:
                _telemetry.gauge("serve.tokens_per_sec").set(
                    self._tokens_generated / dt)

    # -- drivers -------------------------------------------------------------
    def run_until_idle(self, max_steps=1_000_000):
        """Drive ``step()`` until no request is pending or running;
        returns the number of steps taken."""
        n = 0
        while not self.scheduler.idle():
            if n >= max_steps:
                raise MXNetError(
                    f"serving: run_until_idle exceeded {max_steps} steps "
                    "with work still queued — wedged scheduler?")
            self.step()
            n += 1
        return n

    def stream(self, prompt, max_new_tokens=16, request_id=None):
        """Submit and yield tokens as they are generated (drives the
        engine loop from the consuming thread)."""
        req = self.submit(prompt, max_new_tokens, request_id=request_id)
        seen = 0
        while True:
            while seen < len(req.tokens):
                yield req.tokens[seen]
                seen += 1
            if req.done:
                return
            self.step()
