"""The request front-end: streams of requests in, batched decode out.

The port of ``tpu_mx/serving/server.py``'s serving loop.
:class:`Server` turns a stream of generation requests into scheduler and
engine work:

- ``submit(prompt, max_new_tokens)`` admits a request (any thread) and
  returns its :class:`~tpu_mx_torch.serving.scheduler.Request` handle,
  or raises :class:`~tpu_mx_torch.serving.scheduler.AdmissionReject`
  with a reason — the bounded-queue backpressure contract;
- ``step()`` runs ONE engine iteration: admit + prefill newly admissible
  requests, decode the running batch one token, evict finished sequences
  at once.  The caller drives the loop (``run_until_idle()``), which
  keeps the data plane single-threaded and deterministic;
- ``stream(prompt, ...)`` submits and yields tokens as they are
  generated, driving ``step()`` underneath.

Not yet ported (ROADMAP): the watchdog and classified-restart ladder, the
committed-token journal and ``recover()``, SLO monitoring, drain and
handoff, the capacity gauges, and non-greedy sampling.  An engine fault
(:class:`NumericDivergence`, a CUDA error) propagates to the caller
after the step's unstarted admissions are put back in the queue.
"""
from __future__ import annotations

import time

import torch

from ..base import MXNetError
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .engine import EngineCore
from .kv_cache import CacheExhausted
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["Server"]


class Server:
    """See module docstring.

    ``model`` is a :class:`~tpu_mx_torch.serving.model.TinyLM` on
    ``device`` (default ``"cuda"``; the two must agree).  ``scheduler``
    defaults to a :class:`ContinuousBatchingScheduler` built from
    ``max_pending``/``max_batch``/``max_tokens``/``tenants``;
    ``block_size``/``num_blocks``/``dtype`` size the paged cache;
    ``eos_id`` optionally ends generation early.  ``sampling`` must be
    ``"greedy"``: top-k sampling is not ported yet."""

    def __init__(self, model, *, scheduler=None, max_pending=64,
                 max_batch=8, max_tokens=8192, block_size=16,
                 num_blocks=256, eos_id=None, tenants=None,
                 dtype=torch.float32, sampling="greedy", device="cuda"):
        dev = _device.resolve(device)
        if model.device.type != dev.type:
            raise MXNetError(f"Server(device={str(device)!r}): the model's "
                             f"weights are on {model.device}")
        if sampling != "greedy":
            raise MXNetError(
                f"Server(sampling={sampling!r}): only greedy decoding is "
                "ported; top-k sampling waits for its ROADMAP item "
                "(serving/sampling.py)")
        self.model = model
        self.device = dev
        self.scheduler = scheduler if scheduler is not None else \
            ContinuousBatchingScheduler(max_pending=max_pending,
                                        max_batch=max_batch,
                                        max_tokens=max_tokens,
                                        tenants=tenants)
        self.engine = EngineCore(model, block_size=block_size,
                                 num_blocks=num_blocks, dtype=dtype)
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
                first = self.engine.prefill(req)
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
            req.timeline.mark_prefill_end()
            self.scheduler.mark_running(req)
            self._commit_token(req, first)
            worked = True
        batch = self.scheduler.decode_batch()
        if batch:
            if self._t_first_work is None:
                self._t_first_work = time.perf_counter()
            items = [(r, r.tokens[-1]) for r in batch]
            t0 = time.perf_counter()
            results, preempted = self.engine.decode(items)
            for req in batch:
                for token in results.get(req.id, ()):
                    self._commit_token(req, token)
            for req in preempted:
                _tracing.emit("serve.evict", request=req.id,
                              reason="preempted", generated=len(req.tokens))
                self.scheduler.requeue(req)
            _telemetry.counter("serve.decode_steps").inc()
            _tracing.emit("serve.decode", batch=len(items),
                          tokens=len(results), t0=t0, t1=time.perf_counter())
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
