"""Inference serving on the card: paged KV cache, continuous batching.

The port of ``tpu_mx/serving``'s main path, bottom up:

- :mod:`.kv_cache` — block pools on the device + refcounted free-list
  allocator + per-sequence block tables; exhaustion is backpressure
  (:class:`CacheExhausted`), never OOM.
- :mod:`.prefix_cache` — the shared-prefix index: requests with a
  common template share its cached blocks (``TPUMX_PREFIX_SHARING``).
- :mod:`.attention` — flash-kernel prefill; decode on the reference's
  arms (``TPUMX_PAGED_DECODE``: dense gather, paged, the paged kernel).
- :mod:`.model` — :class:`TinyLM`, the seed-deterministic model, with
  its whole decode step on the device and the host layer loop's pieces.
- :mod:`.jax_model` — the fused-step knob (``TPUMX_FUSED_DECODE``).
- :mod:`.accounting` — the capacity ledger: every block reference
  attributed to a holder and a tenant, exhaustion forensics.
- :mod:`.scheduler` — admission, continuous batching, tenant fairness,
  the static-batching baseline.
- :mod:`.speculative` — draft on the device, verify a ``(B, K)`` window
  in one step (``TPUMX_SPECULATIVE``).
- :mod:`.sampling` — top-k samplers whose state is data.
- :mod:`.engine` — model + cache = prefill/decode compute, on the fused
  arm or the host layer loop, with the sampled decode self-check
  (``TPUMX_SELF_CHECK``).
- :mod:`.server` — ``submit``/``step``/``run_until_idle``/``stream``,
  supervised: watchdog, classified restarts, ``drain``/``handoff``/
  ``recover``.
- :mod:`.journal` — the committed-token journal ``recover()`` reads.
- :mod:`.slo` — the live SLO monitor (windowed attainment, burn rate).
- :mod:`.tenancy`, :mod:`.timeline` — tenant policy, latency attribution.
"""
from .accounting import (CapacityLedger, FORENSIC_FORMAT,
                         validate_forensic_doc, validate_forensic_record)
from .kv_cache import (BlockAllocator, CacheExhausted, PagedKVCache,
                       PrefillPlan, prefix_sharing_enabled)
from .prefix_cache import PrefixIndex
from .tenancy import TenantConfig, TenantTable
from .attention import decode_attention, dense_attention, prefill_attention
from .model import TinyLM
from .timeline import RequestTimeline
from .slo import SLO, SLOMonitor
from .scheduler import (AdmissionReject, ContinuousBatchingScheduler,
                        Request, StaticBatchingScheduler)
from .journal import TokenJournal
from .engine import EngineCore
from .server import Server

__all__ = ["BlockAllocator", "CacheExhausted", "PagedKVCache",
           "PrefillPlan", "PrefixIndex", "prefix_sharing_enabled",
           "TenantConfig", "TenantTable", "dense_attention",
           "decode_attention", "prefill_attention", "TinyLM",
           "RequestTimeline", "AdmissionReject",
           "ContinuousBatchingScheduler", "Request",
           "StaticBatchingScheduler", "EngineCore", "Server", "SLO",
           "SLOMonitor", "TokenJournal", "CapacityLedger", "FORENSIC_FORMAT",
           "validate_forensic_doc", "validate_forensic_record"]
