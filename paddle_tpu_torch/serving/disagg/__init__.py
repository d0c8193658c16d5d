"""Disaggregated prefill/decode serving (port of paddle_tpu/serving/disagg).

Only :mod:`.tenancy` is ported: per-tenant priority classes, quotas and
SLO targets, whose :func:`resolve_priority` the HTTP frontend uses to
validate a ``:generate`` request's ``priority``. The KV handoff wire
format (``kv_wire``), the prefill-only engine (``prefill``) and the
session-affine router (``router``) wait for ROADMAP.md Queue 1 item 7.3.
"""
from .tenancy import (  # noqa: F401
    PRIORITY_CLASSES, TenantSpec, TenantTable, resolve_priority,
)

__all__ = ["PRIORITY_CLASSES", "TenantSpec", "TenantTable",
           "resolve_priority"]
