"""Typed error hierarchy for fei_tpu_torch (a copy of fei_tpu.utils.errors).

The reference maps transport errors ad hoc (fei/core/assistant.py:543-554 maps
LiteLLM exceptions to strings); here every subsystem raises a typed subclass of
FeiError so callers can catch at the right granularity.
"""

from __future__ import annotations


class FeiError(Exception):
    """Base class for all fei_tpu_torch errors."""

    def __init__(self, message: str, *, cause: Exception | None = None):
        super().__init__(message)
        self.message = message
        self.cause = cause


class ConfigError(FeiError):
    """Invalid or missing configuration."""


class ProviderError(FeiError):
    """LLM provider failure (local engine or remote API)."""


class AuthenticationError(ProviderError):
    """Missing or rejected credentials for a remote provider."""


class RateLimitError(ProviderError):
    """Remote provider rate limit."""


class EngineError(FeiError):
    """TPU inference engine failure (compile, OOM, shape mismatch)."""


class RequestError(EngineError):
    """Host-side failure scoped to ONE request (bad grammar table,
    tokenizer edge case, a user callback that raised). The scheduler
    fails only the offending sequence — its slot evicts through the
    healthy-pool path and every other stream keeps decoding."""


class DeviceError(EngineError):
    """Device-scoped failure: the donated KV pool must be presumed
    consumed (mid-execution dispatch failure). Routes to the
    scheduler's ``_fail_all`` — pool dropped and rebuilt on the next
    admission; every in-flight request fails."""


class QueueFullError(RequestError):
    """Backpressure: the scheduler's waiting queue is at
    ``FEI_TPU_MAX_QUEUE``. The server maps this to HTTP 429 with a
    ``Retry-After`` hint (``retry_after_s``)."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause)
        self.retry_after_s = retry_after_s


class EngineDegradedError(EngineError):
    """The crash-loop breaker tripped: N device failures inside the
    breaker window. New submits are rejected (HTTP 503 with
    ``Retry-After``) until the cooldown elapses or the operator calls
    ``scheduler.reset_degraded()`` — rebuilding the pool on every
    doomed request would just thrash HBM."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(RequestError):
    """The request's deadline expired — shed at admission (queue wait
    alone blew the budget) or cancelled mid-decode at delivery."""


class PoolPressure(EngineError):
    """The paged KV pool could not satisfy a page allocation on the
    scheduler path. NOT a request failure: the scheduler treats pressure
    as a scheduling event (evict prefix-cache entries, preempt a victim
    sequence, retry) — only a request whose worst case can never fit the
    pool fails, and that is rejected typed at submit()."""


class EngineDrainingError(EngineError):
    """The engine is draining (SIGTERM / POST /drain): new submits are
    rejected (HTTP 503 + ``Retry-After``) while in-flight requests finish
    within ``FEI_TPU_DRAIN_DEADLINE_S``; still-queued requests snapshot
    to disk for warm restart."""

    def __init__(self, message: str, *, retry_after_s: float = 5.0,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause)
        self.retry_after_s = retry_after_s


class CheckpointError(EngineError):
    """Weight loading / checkpoint save-restore failure."""


class TrainingError(EngineError):
    """The training path was given something it cannot differentiate
    (quantized parameter leaves) or an optimizer state that does not fit
    the parameters."""


class KVTierError(EngineError):
    """Tiered KV store failure (missing/corrupt/mismatched page entry,
    tier I/O error, incompatible migration blob). Always recoverable at
    the scheduler: a failed fetch falls back to token replay and a failed
    spill just forfeits the fast-resume path — neither may wedge a slot."""


class KVGeometryError(KVTierError):
    """The blob's INVARIANT pool geometry (layers, total kv heads,
    page_size, head_dim, dtype, quantized) can never scatter into this
    pool — a different model, dtype, or page size, not a different mesh.
    Never retryable: the server maps this to HTTP 409 with the
    ``{ours, theirs}`` diff so the router stops re-offering the blob,
    unlike a corrupt/truncated 422 it may refetch elsewhere. A mere tp
    *layout* skew is NOT this error — layout resheds on scatter."""

    def __init__(self, message: str, *, ours: dict | None = None,
                 theirs: dict | None = None,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause)
        self.ours = dict(ours or {})
        self.theirs = dict(theirs or {})


class PageSizeMismatchError(CheckpointError):
    """A durable artifact (drain snapshot, journal session) was produced
    under a different KV page_size than this engine serves. Page size
    changes the paged kernel's summation order, so a cross-page_size
    replay cannot promise byte-identity — the ONE geometry axis warm
    restart still refuses (mesh shape resheds/replays freely)."""

    def __init__(self, message: str, *, ours: int | None = None,
                 theirs: int | None = None,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause)
        self.ours = ours
        self.theirs = theirs


class ToolError(FeiError):
    """Tool registration, validation, or execution failure."""


class ToolNotFoundError(ToolError):
    pass


class ToolValidationError(ToolError):
    """Arguments failed JSON-schema validation."""


class MemoryError_(FeiError):
    """Memdir / Memorychain subsystem failure (trailing underscore avoids
    shadowing the builtin)."""


class ConnectionError_(MemoryError_):
    """A memory service endpoint is unreachable (trailing underscore avoids
    shadowing the builtin)."""


class MCPError(FeiError):
    """MCP client/service failure."""


class TaskExecutionError(FeiError):
    """Continuous task executor failure."""
