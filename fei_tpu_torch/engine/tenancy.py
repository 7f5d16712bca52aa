"""Multi-tenant QoS policy for the paged scheduler (a copy of
fei_tpu/engine/tenancy.py).

One greedy tenant must not starve everyone else: requests carry a
``tenant`` label and an integer ``priority`` (GenerationConfig fields,
fed from the request body or the ``X-FEI-Tenant`` / ``X-FEI-Priority``
headers), and admission becomes weighted-fair across tenants instead of
strictly FIFO. The policy table comes from ``FEI_TPU_TENANT_BUDGETS``::

    FEI_TPU_TENANT_BUDGETS="gold:4,silver:2:8,bronze:1:4:4096,*:1"

Comma-separated ``tenant:weight[:queue_cap[:token_budget]]`` entries —
``weight`` scales the tenant's fair share of served tokens,
``queue_cap`` bounds its waiting requests (0 = only the global
FEI_TPU_MAX_QUEUE applies), ``token_budget`` caps the token positions
its running sequences may hold reserved at once (0 = unlimited). A
``*`` entry sets the policy for tenants not named explicitly. With no
spec configured every tenant shares one default policy and — as long as
all priorities are equal — admission degrades to exactly the legacy
FIFO order, so single-tenant behavior (and its byte-identity proofs)
is unchanged.

Fairness is start-time weighted fair queueing over served tokens: each
tenant accrues virtual time ``tokens / weight`` as its sequences emit,
and admission picks, among the highest waiting priority class, the
backlogged tenant with the least virtual time. A tenant going from idle
to backlogged re-anchors at the busy tenants' floor so it competes for
its share from now on instead of replaying its idle history as debt
owed to it.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tenancy")

# tenant labels become metric-name segments (``tenant.<name>.sheds``);
# anything outside this alphabet is squashed so a hostile label can't
# mangle the Prometheus exposition
_NAME_RE = re.compile(r"[^A-Za-z0-9_\-]+")

# priorities are small ordinal classes, not a continuum; clamping keeps
# a fat-fingered "priority": 999999 from pinning the victim ladder
MAX_PRIORITY = 9


def sanitize_tenant(name: str) -> str:
    return _NAME_RE.sub("_", str(name).strip())[:64] or "default"


def clamp_priority(p) -> int:
    try:
        return max(0, min(MAX_PRIORITY, int(p)))
    except (TypeError, ValueError):
        return 0


@dataclass(frozen=True)
class TenantPolicy:
    name: str
    weight: float = 1.0
    queue_cap: int = 0      # waiting requests (0 = global cap only)
    token_budget: int = 0   # reserved token positions in slots (0 = none)


def parse_tenant_budgets(spec: str) -> dict[str, TenantPolicy]:
    """Parse ``FEI_TPU_TENANT_BUDGETS``. Malformed entries log and skip
    (matching FEI_TPU_FAULT's forgiving parse) — a typo in one tenant
    must not take the whole policy table down with it."""
    table: dict[str, TenantPolicy] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip()
        if not name:
            log.warning("malformed FEI_TPU_TENANT_BUDGETS entry %r", part)
            continue
        if name != "*":
            name = sanitize_tenant(name)
        try:
            weight = float(fields[1]) if len(fields) > 1 else 1.0
            queue_cap = int(fields[2]) if len(fields) > 2 else 0
            token_budget = int(fields[3]) if len(fields) > 3 else 0
        except ValueError:
            log.warning("malformed FEI_TPU_TENANT_BUDGETS entry %r", part)
            continue
        if weight <= 0:
            log.warning(
                "FEI_TPU_TENANT_BUDGETS entry %r has non-positive weight; "
                "using 1", part,
            )
            weight = 1.0
        table[name] = TenantPolicy(
            name=name, weight=weight,
            queue_cap=max(0, queue_cap), token_budget=max(0, token_budget),
        )
    return table


class TenantBook:
    """Per-tenant accounting the scheduler consults under its lock: the
    policy table plus each tenant's weighted-fair virtual time. All
    methods are lock-free on their own — the scheduler's single lock
    already serializes every caller."""

    def __init__(self, policies: dict[str, TenantPolicy] | None = None,
                 default_tenant: str | None = None):
        if policies is None:
            policies = parse_tenant_budgets(
                os.environ.get("FEI_TPU_TENANT_BUDGETS", "")
            )
        self.policies = dict(policies)
        self.default_tenant = sanitize_tenant(
            default_tenant
            if default_tenant is not None
            else os.environ.get("FEI_TPU_DEFAULT_TENANT", "default")
        )
        self._fallback = self.policies.get("*") or TenantPolicy(name="*")
        self._vtime: dict[str, float] = {}

    @property
    def configured(self) -> bool:
        """False when no policy table is set — the scheduler's fast path
        (exact legacy FIFO) only needs priorities to also be uniform."""
        return bool(self.policies)

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self._fallback)

    def vtime(self, tenant: str) -> float:
        return self._vtime.get(tenant, 0.0)

    def charge(self, tenant: str, tokens: int) -> None:
        """Accrue ``tokens`` of service: virtual time advances inversely
        to the tenant's weight, so a weight-4 tenant earns 4x the tokens
        per unit of virtual time."""
        w = max(self.policy(tenant).weight, 1e-9)
        self._vtime[tenant] = self._vtime.get(tenant, 0.0) + tokens / w

    def activate(self, tenant: str, busy_vtimes) -> None:
        """A tenant just became backlogged: re-anchor its virtual time at
        the floor of the currently-busy tenants so idle time is neither
        banked as credit nor charged as debt (standard start-time WFQ)."""
        floor = min(busy_vtimes, default=0.0)
        if self._vtime.get(tenant, 0.0) < floor:
            self._vtime[tenant] = floor
