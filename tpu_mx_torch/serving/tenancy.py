"""Multi-tenant policy: per-tenant weights, quotas, and bounded labels.

A copy of ``tpu_mx/serving/tenancy.py``'s policy core (no jax in it,
but the port imports nothing of the reference package).  "Millions of users" are not
one queue — they are tenants with different priorities, traffic
shapes, and blast radii.  This module is the small, declarative policy
surface the scheduler and server consume:

- :class:`TenantConfig` — one tenant's knobs: ``weight`` (its share of
  the admission bandwidth under the weighted fair policy —
  serving/scheduler.py), ``max_inflight`` (admitted-and-
  unfinished request cap) and ``token_quota`` (worst-case in-flight
  token cap, the same ``budget_tokens`` unit the scheduler's global
  ``max_tokens`` budget uses).  Exceeding either gets
  ``AdmissionReject(reason="tenant_quota")`` — backpressure per tenant,
  so one tenant's burst can never starve the fleet.
- :class:`TenantTable` — the registry.  Unknown tenants resolve to a
  permissive default (weight 1, no caps): single-tenant callers never
  have to know tenancy exists, and the pre-tenancy behavior is exactly
  the one-tenant special case.
- :func:`label_for` — the bounded-cardinality telemetry label.  Tenant
  ids are client-controlled strings; using them raw as metric labels
  would let one misbehaving client mint unbounded series.  The first
  ``TENANT_LABEL_CAP`` distinct tenants seen by the process keep their
  name; every later one collapses into the ``_other`` overflow label.
"""
from __future__ import annotations

import threading

__all__ = ["DEFAULT_TENANT", "TENANT_LABEL_CAP", "OVERFLOW_LABEL",
           "TenantConfig", "TenantTable", "label_for",
           "reset_label_registry"]

DEFAULT_TENANT = "default"

# telemetry-label cardinality cap: first N distinct tenant ids keep
# their own label, the rest share the overflow label (docs/observability
# .md).  Configured tenants are pre-registered by TenantTable, so a
# declared tenant can never be squeezed out by anonymous traffic.
TENANT_LABEL_CAP = 16
OVERFLOW_LABEL = "_other"

_label_lock = threading.Lock()
_labels: dict = {}


def label_for(tenant):
    """The bounded telemetry label for ``tenant`` (see module
    docstring): its own name for the first :data:`TENANT_LABEL_CAP`
    distinct tenants, :data:`OVERFLOW_LABEL` afterwards.  Stable within
    a process.  Past-cap ids are NOT remembered: tenant ids are
    client-controlled strings, so the registry itself must stay
    bounded — an id-per-request stream maps to the overflow label
    without growing process memory."""
    tenant = str(tenant)
    with _label_lock:
        got = _labels.get(tenant)
        if got is not None:
            return got
        if len(_labels) >= TENANT_LABEL_CAP:
            return OVERFLOW_LABEL
        _labels[tenant] = tenant
        return tenant


def reset_label_registry():
    """Forget every label given out (between tests: the cap goes to the
    first tenants named)."""
    with _label_lock:
        _labels.clear()


class TenantConfig:
    """One tenant's declarative policy — see module docstring.
    ``weight`` must be positive; ``max_inflight``/``token_quota`` are
    caps on admitted-and-unfinished work (None = uncapped)."""

    __slots__ = ("tenant", "weight", "max_inflight", "token_quota")

    def __init__(self, tenant, weight=1.0, max_inflight=None,
                 token_quota=None):
        self.tenant = str(tenant)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"TenantConfig({tenant!r}): weight must be "
                             f"positive, got {weight}")
        self.max_inflight = None if max_inflight is None \
            else int(max_inflight)
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(f"TenantConfig({tenant!r}): max_inflight "
                             f"must be >= 1, got {max_inflight}")
        self.token_quota = None if token_quota is None else int(token_quota)
        if self.token_quota is not None and self.token_quota < 1:
            raise ValueError(f"TenantConfig({tenant!r}): token_quota "
                             f"must be >= 1, got {token_quota}")

    def __repr__(self):
        return (f"TenantConfig({self.tenant!r}, weight={self.weight}, "
                f"max_inflight={self.max_inflight}, "
                f"token_quota={self.token_quota})")


class TenantTable:
    """The tenant registry.  ``get`` never fails: unknown tenants
    resolve to a shared permissive default config, so tenancy is purely
    additive — a server with no table behaves exactly as before."""

    def __init__(self, configs=()):
        self._configs = {}
        for cfg in configs:
            if not isinstance(cfg, TenantConfig):
                raise TypeError(f"TenantTable takes TenantConfig entries, "
                                f"got {type(cfg).__name__}")
            if cfg.tenant in self._configs:
                raise ValueError(f"duplicate tenant {cfg.tenant!r}")
            self._configs[cfg.tenant] = cfg
            label_for(cfg.tenant)   # declared tenants get real labels
        self._default = TenantConfig("_default_")

    @classmethod
    def coerce(cls, obj):
        """``None`` → empty table; a table → itself; an iterable of
        :class:`TenantConfig` → a table; a ``{tenant: {knobs...}}``
        mapping → a table (the config-file shape)."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(TenantConfig(t, **(kw or {}))
                       for t, kw in obj.items())
        return cls(obj)

    def get(self, tenant):
        """``tenant``'s config, or the permissive default."""
        return self._configs.get(str(tenant), self._default)

    def configured(self):
        """The ids of the tenants declared explicitly."""
        return list(self._configs)

    def __repr__(self):
        return f"TenantTable({sorted(self._configs)})"
