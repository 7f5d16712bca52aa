"""Declared metric names — the single source of truth for dashboards
(counterpart of fei_tpu/obs/registry.py).

Every ``METRICS.incr/gauge/observe/span/timing`` call site in
fei_tpu_torch/ must use a name declared here (wildcards allowed for
families like ``tool.*``); tests/test_torch_obs.py scans the package in
tier-1 so a renamed or ad-hoc metric cannot drift away from dashboards.
The table is the JAX package's, plus a commented block of the names only
the port sets.
"""

from __future__ import annotations

from fnmatch import fnmatch

# name (or fnmatch pattern) -> (kind, help text)
METRIC_REGISTRY: dict[str, tuple[str, str]] = {
    # --- counters -------------------------------------------------------
    "agent.tool_calls": ("counter", "Tool calls issued by the assistant loop."),
    "agent.prompt_tokens": ("counter", "Prompt tokens consumed by LLM calls."),
    "agent.completion_tokens": ("counter",
                                "Completion tokens produced by LLM calls."),
    "tool.calls": ("counter", "Tool executions via the registry."),
    "tool.errors": ("counter", "Tool executions that raised."),
    "scheduler.requests_submitted": ("counter",
                                     "Sequences submitted to the scheduler."),
    "scheduler.requests_completed": ("counter",
                                     "Sequences finished normally."),
    "scheduler.requests_cancelled": ("counter", "Sequences cancelled."),
    "scheduler.requests_failed": ("counter",
                                  "Sequences failed with an error."),
    "scheduler.requests_failed_isolated": (
        "counter", "Request-scoped failures contained to one sequence "
                   "(slot evicted via the healthy-pool path; other "
                   "streams unaffected)."),
    "scheduler.requests_shed": (
        "counter", "Requests rejected by backpressure: waiting queue at "
                   "FEI_TPU_MAX_QUEUE, degraded-state rejections, or "
                   "deadline already expired while queued."),
    "scheduler.requests_deadline_exceeded": (
        "counter", "Sequences that hit their deadline (shed at admission "
                   "or cancelled mid-decode)."),
    "scheduler.admission_blocked": ("counter",
                                    "Admissions deferred by page-pool "
                                    "pressure."),
    "scheduler.preemptions": (
        "counter", "Sequences preempted under KV-pool pressure (snapshot "
                   "+ release + requeue; they resume byte-identically)."),
    "scheduler.preempted_tokens_recomputed": (
        "counter", "Token positions re-prefilled when preempted sequences "
                   "resumed (prefix-cache hits excluded)."),
    "scheduler.resume_replayed_tokens": (
        "counter", "Generated-suffix tokens replayed through the decode-"
                   "shaped forward at resume (bitwise KV rebuild)."),
    "scheduler.prefill_tokens": (
        "counter", "Prompt tokens actually prefilled at admission "
                   "(prefix-cache and content-addressed tier hits "
                   "excluded); divide by total prompt tokens for the "
                   "flops-saved ratio."),
    "scheduler.lazy_grown_pages": (
        "counter", "KV pages allocated mid-decode for lazily-reserved "
                   "sequences."),
    "scheduler.requests_snapshotted": (
        "counter", "Requests snapshotted to disk at drain for warm "
                   "restart."),
    "scheduler.requests_restored": (
        "counter", "Snapshotted requests re-admitted by a warm restart."),
    "scheduler.decode_steps": ("counter",
                               "Device decode steps dispatched."),
    "scheduler.decode_slot_steps": ("counter",
                                    "Per-slot decode steps (steps x active "
                                    "slots)."),
    "scheduler.paged_prefill_disabled": ("counter",
                                         "Paged-native prefill fallbacks."),
    "scheduler.ragged_disabled": (
        "counter", "Merged ragged dispatches disarmed after an on-chip "
                   "failure (legacy two-program path takes over)."),
    "scheduler.spec_steps": ("counter", "Speculative decode steps."),
    "scheduler.spec_accepted": ("counter",
                                "Speculative tokens accepted."),
    "scheduler.spec_disabled": ("counter",
                                "Speculation disabled for a sequence."),
    "scheduler.host_mask_uploads": ("counter",
                                    "Host-side grammar mask uploads."),
    "scheduler.multi_steps": ("counter", "Multi-step decode dispatches."),
    "scheduler.multi_tokens": ("counter",
                               "Tokens produced by multi-step decode."),
    "scheduler.turbo_under_admission": (
        "counter", "Multi-step dispatches run while an admission was "
                   "queued or prefilling in chunks."),
    "scheduler.turbo_rollbacks": (
        "counter", "Free-phase slots rolled back to a mid-scan grammar "
                   "trigger (pool length + rng key restored)."),
    "scheduler.turbo_rollback_tokens": (
        "counter", "Scanned-ahead tokens discarded by free-phase trigger "
                   "rollbacks."),
    "scheduler.swa_pages_released": ("counter",
                                     "KV pages released by sliding-window "
                                     "attention."),
    "scheduler.grammar_trigger_suffix_rejected": (
        "counter", "Grammar trigger suffixes rejected by the matcher."),
    "scheduler.grammar_walked_off": (
        "counter", "Grammar walks that left the trigger automaton."),
    "engine.sp_prefills": ("counter", "Sequence-parallel prefill launches."),
    "engine.decode_dispatches": ("counter",
                                 "Free-phase decode dispatches (fused "
                                 "chunks or per-token steps) — per-token "
                                 "regressions show as a jump vs tokens "
                                 "emitted."),
    "engine.ragged_dispatches": (
        "counter", "Merged ragged dispatches: decode scans that also "
                   "carried a prefill chunk in one program (one weight "
                   "stream for both)."),
    "engine.kernel_loop_depth": (
        "gauge", "Scanned depth of the last decode dispatch in layer "
                 "programs (steps x layers collapsed into one "
                 "dispatch)."),
    "engine.grammar_trigger_suffix_rejected": (
        "counter", "Grammar trigger suffixes rejected (engine path)."),
    "engine.grammar_budget_too_small": (
        "counter", "Fused grammar chunks skipped: token budget too small."),
    "engine.grammar_fused_steps": ("counter",
                                   "Fused grammar-constrained steps."),
    "engine.grammar_walked_off": (
        "counter", "Grammar walks off the automaton (engine path)."),
    "prefix.hits": ("counter", "Prefix-cache hits on admission."),
    "prefix.misses": ("counter", "Prefix-cache misses on admission."),
    "prefix.evictions": ("counter", "Prefix-cache entries evicted."),
    "server.requests": ("counter", "HTTP requests handled by the API core."),
    "provider.retries": ("counter",
                         "Remote provider HTTP attempts retried "
                         "(connection errors and 429/5xx)."),
    "server.profile_captures": ("counter",
                                "On-demand torch.profiler captures taken (/debug/profile)."),
    "server.drains": ("counter", "Graceful drains initiated via POST "
                                 "/drain."),
    "scheduler.priority_preemptions": (
        "counter", "Running sequences preempted by a strictly higher-"
                   "priority arrival when every slot was busy (the victim "
                   "re-queues and resumes byte-identically)."),
    "scheduler.tenant_budget_deferred": (
        "counter", "Admissions deferred because the candidate tenant's "
                   "reserved-token inflight would exceed its "
                   "FEI_TPU_TENANT_BUDGETS token budget."),
    "tenant.*.tokens_served": ("counter",
                               "Tokens delivered to one tenant's "
                               "requests (per-tenant family)."),
    "tenant.*.sheds": ("counter",
                       "Requests from one tenant rejected by "
                       "backpressure or evicted from the full queue by a "
                       "higher-priority arrival."),
    "tenant.*.preemptions": ("counter",
                             "Preemptions (pool-pressure or priority) "
                             "charged to one tenant's sequences."),
    "router.requests": ("counter", "Requests routed by the fleet router."),
    "router.retries": ("counter",
                       "Forward attempts retried on another replica "
                       "(connection failures and 429/503 backpressure)."),
    "router.ejections": ("counter",
                         "Replicas ejected by the per-replica circuit "
                         "breaker (consecutive-failure threshold)."),
    "router.readmissions": ("counter",
                            "Ejected replicas readmitted after a "
                            "successful half-open health probe."),
    "router.affinity_hits": ("counter",
                             "Requests routed to their session/prefix "
                             "affinity replica."),
    "router.affinity_misses": ("counter",
                               "Affinity lookups that fell back (replica "
                               "draining, ejected, or unknown key)."),
    "router.sheds": ("counter",
                     "Requests the router shed with 503 after every "
                     "replica was unusable or retries were exhausted."),
    "router.invalid_requests": ("counter",
                                "Malformed client requests answered 400 "
                                "at the router without charging any "
                                "replica's breaker."),
    "router.deadline_expired": ("counter",
                                "Requests that ran out of client deadline "
                                "inside the router retry loop (504)."),
    "router.rolling_restarts": ("counter",
                                "Zero-downtime rolling restarts completed "
                                "across the replica set."),
    "router.role_routed": ("counter",
                           "Requests steered by the replica role split "
                           "(prefill-heavy vs decode/mixed preference "
                           "narrowed the candidate set)."),
    "router.migrations": ("counter",
                          "KV sessions migrated between replicas over the "
                          "/kv/export -> /kv/import control plane "
                          "(affinity-miss repair and prefill->decode "
                          "handoff)."),
    "router.migration_failures": ("counter",
                                  "KV migrations that failed or were "
                                  "refused (target full, corrupt blob, "
                                  "transport error); the session simply "
                                  "re-prefills."),
    "kv.spills": ("counter",
                  "Preempted sequences whose KV pages were spilled to the "
                  "host tier (the spill-before-preempt rung)."),
    "kv.spill_failures": ("counter",
                          "Spill attempts that failed (tier I/O, injected "
                          "fault); the sequence still resumes via token "
                          "replay."),
    "kv.pages_spilled": ("counter",
                         "KV pages copied HBM -> host tier at preemption."),
    "kv.bytes_spilled": ("counter",
                         "Bytes copied HBM -> host tier at preemption."),
    "kv.fetches": ("counter",
                   "Resumes served by streaming spilled pages back instead "
                   "of re-prefilling."),
    "kv.pages_restored": ("counter",
                          "KV pages streamed host tier -> HBM at resume."),
    "kv.bytes_fetched": ("counter",
                         "Bytes streamed host tier -> HBM at resume."),
    "kv.fetch_misses": ("counter",
                        "Tier lookups that found no entry (evicted or "
                        "never spilled); resume falls back to replay."),
    "kv.fetch_corrupt": ("counter",
                         "Tier entries rejected by checksum/format "
                         "validation; the entry is discarded and resume "
                         "falls back to replay."),
    "kv.fetch_fallbacks": ("counter",
                           "Resumes that fell back to token replay after "
                           "the tier could not serve them (miss, corrupt, "
                           "stale, or I/O error)."),
    "kv.demotions": ("counter",
                     "Tier entries demoted host RAM -> disk by the RAM "
                     "budget (FEI_TPU_KV_RAM_BYTES)."),
    "kv.evictions": ("counter",
                     "Tier entries dropped entirely by budget pressure "
                     "(no disk tier, or disk budget exceeded)."),
    "kv.migrations_out": ("counter",
                          "Sessions exported as migration blobs by this "
                          "replica."),
    "kv.migrations_in": ("counter",
                         "Migration blobs imported into this replica's "
                         "pool and prefix cache."),
    "kv.pages_migrated": ("counter",
                          "KV pages landed by migration imports."),
    "kv.bytes_migrated": ("counter",
                          "Bytes serialized into migration blobs."),
    "kv.cas_stores": ("counter",
                      "Content-addressed prefix blobs stored in the tier "
                      "(first copy of that content)."),
    "kv.cas_dedup_hits": ("counter",
                          "Content-addressed publishes deduplicated "
                          "against an existing tier copy (N sessions, "
                          "one copy)."),
    "kv.prefix_hits_tier": ("counter",
                            "Admissions whose prefix pages were fetched "
                            "from the local tier by content hash instead "
                            "of re-prefilled."),
    "kv.prefix_tokens_saved": ("counter",
                               "Prompt tokens NOT re-prefilled thanks to "
                               "content-addressed tier hits."),
    "kv.prefix_hits_remote": ("counter",
                              "Prefix blobs the router fetched from a "
                              "peer replica and placed ahead of a cold "
                              "forward."),
    "router.prefix_fetch_failures": ("counter",
                                     "Best-effort peer prefix fetches "
                                     "that failed (probe error, no "
                                     "source served the blob, push "
                                     "refused); the session simply "
                                     "prefills."),
    "router.prewarm_pushes": ("counter",
                              "Hot prefix blobs pushed into a replica by "
                              "speculative pre-warm (rolling restart / "
                              "scale-up)."),
    "router.prewarm_failures": ("counter",
                                "Pre-warm pushes that failed (replica "
                                "unreachable, refused, or corrupt blob); "
                                "the replica serves cold instead."),
    "journal.appends": ("counter",
                        "Records appended to the crash-consistency "
                        "session journal (admissions, delivered tokens, "
                        "terminals)."),
    "journal.bytes": ("counter",
                      "Bytes written to the session journal (framing "
                      "included)."),
    "journal.fsyncs": ("counter",
                       "fsync() calls issued by the journal writer "
                       "(FEI_TPU_JOURNAL_SYNC=batch coalesces; =always "
                       "is one per record)."),
    "journal.recovered_sessions": ("counter",
                                   "Unfinished sessions re-admitted from "
                                   "the journal at warm restart "
                                   "(byte-identical replay)."),
    "journal.torn_records": ("counter",
                             "Half-appended journal records discarded at "
                             "recovery (the crash landed mid-write; "
                             "committed tokens are never among them)."),
    "engine.crash_recoveries": ("counter",
                                "Warm restarts that found and replayed "
                                "at least one journaled session."),
    "engine.recovery_skipped.*": ("counter",
                                  "Journaled sessions a warm restart "
                                  "could NOT re-admit, by reason "
                                  "(page_size: the one geometry gate; "
                                  "deadline_expired: the client's "
                                  "budget ran out mid-crash)."),
    "engine.cross_mesh_recoveries": ("counter",
                                     "Journaled sessions re-admitted "
                                     "onto a DIFFERENT mesh than the "
                                     "one that crashed (tp2 journal "
                                     "replayed on single-chip, etc.) — "
                                     "byte-identical via teacher-"
                                     "forced replay."),
    "kv.resharded_imports": ("counter",
                             "KV blobs (migration, CAS admit, CDN) "
                             "imported across a tp layout skew — the "
                             "host interchange format carries the full "
                             "kv-head extent, so the scatter resheds "
                             "instead of refusing."),
    "router.geometry_skips": ("counter",
                              "Fleet KV/session moves skipped because "
                              "the replicas' INVARIANT fingerprints "
                              "can never match (heterogeneous fleet: "
                              "different model/dtype/page_size) — "
                              "pre-flight off /health or a 409 from "
                              "the /kv plane; never retried."),
    "router.resurrections": ("counter",
                             "Mid-stream sessions moved to a survivor "
                             "after their replica died with tokens "
                             "already delivered."),
    "router.resurrection_replayed_tokens": (
        "counter",
        "Delivered tokens teacher-forced into a survivor during "
        "resurrection (the client never sees them twice)."),
    "engine.compiles": ("counter",
                        "Jit program compilations observed (first build "
                        "per program signature — warmup cost)."),
    "engine.recompiles": ("counter",
                          "Compilations of an ALREADY-SEEN program "
                          "signature: steady-state recompiles; each one "
                          "is a dropped cache or a shape leak, not "
                          "warmup."),
    # --- gauges ---------------------------------------------------------
    "last_ttft_s": ("gauge", "TTFT of the most recent generation (s)."),
    "last_decode_tok_s": ("gauge",
                          "Decode throughput of the most recent "
                          "generation (tok/s)."),
    "scheduler.queue_depth": ("gauge", "Sequences waiting for admission."),
    "engine.degraded": ("gauge",
                        "1 while the crash-loop breaker holds the engine "
                        "degraded (submits rejected), else 0."),
    "engine.draining": ("gauge",
                        "1 once a graceful drain began (sticky for the "
                        "process lifetime), else 0."),
    "scheduler.running_slots": ("gauge", "Sequences actively decoding."),
    "engine.mesh_shape": ("gauge",
                          "Devices in the serving mesh (1 = single chip); "
                          "per-axis sizes in engine.mesh.*."),
    "engine.mesh.*": ("gauge",
                      "Serving-mesh axis size (dp/tp/ep/sp/pp family; 1 = "
                      "axis unused)."),
    "scheduler.replica.*.slots": ("gauge",
                                  "Active decode slots in one dp replica "
                                  "group's batch slice."),
    "scheduler.replica.*.queue_depth": (
        "gauge", "Waiting requests attributed to one dp replica group "
                 "(balanced share of the shared admission queue)."),
    "scheduler.batch_slots_active": ("gauge",
                                     "Active slots in the last decode "
                                     "dispatch (batch utilization)."),
    "pool.pages_total": ("gauge", "Allocatable KV pages (null page "
                                  "excluded)."),
    "pool.pages_free": ("gauge", "Free KV pages."),
    "pool.pages_in_use": ("gauge", "KV pages currently referenced."),
    "prefix.entries": ("gauge", "Entries resident in the prefix cache."),
    "roofline.frac": ("gauge",
                      "Fraction of the aggregate HBM roofline achieved by "
                      "the most recent decode dispatch (analytical bytes "
                      "estimate / wall time vs FEI_TPU_HBM_GBPS × chips)."),
    "roofline.tok_s_per_chip": ("gauge",
                                "Delivered tokens/s per chip over the most "
                                "recent decode dispatch."),
    "tenant.*.queued": ("gauge",
                        "Sequences from one tenant waiting for admission "
                        "(emitted only when tenant budgets are "
                        "configured)."),
    "tenant.*.running": ("gauge",
                         "Sequences from one tenant actively decoding "
                         "(emitted only when tenant budgets are "
                         "configured)."),
    "router.replicas_usable": ("gauge",
                               "Replicas the fleet router considers "
                               "routable (healthy, not draining, not "
                               "ejected)."),
    "kv.tier_bytes_ram": ("gauge",
                          "Bytes resident in the host-RAM KV tier."),
    "kv.tier_bytes_disk": ("gauge",
                           "Bytes resident in the on-disk KV tier."),
    "kv.tier_entries": ("gauge",
                        "Entries resident across both KV tiers."),
    "kv.dedup_ratio": ("gauge",
                       "Fraction of content-addressed publishes that "
                       "deduplicated against an existing copy "
                       "(hits / (hits + stores))."),
    "kv.spilled_gbps": ("gauge",
                        "Achieved HBM -> host throughput of the most "
                        "recent spill (GB/s)."),
    "kv.fetched_gbps": ("gauge",
                        "Achieved host -> HBM throughput of the most "
                        "recent streamed resume (GB/s)."),
    # --- spans (each also feeds a <name>_seconds histogram) -------------
    "prefill": ("span", "Full prefill dispatch."),
    "prefill_chunk": ("span", "One chunked-prefill chunk."),
    "prefill_sp": ("span", "Sequence-parallel prefill dispatch."),
    "decode_step": ("span", "One device decode step."),
    "dispatch_issue": ("span",
                       "Host time to ISSUE one decode dispatch (call "
                       "until the jitted function returned; the device "
                       "keeps running)."),
    "dispatch_sync": ("span",
                      "Host block-until-ready time for one decode "
                      "dispatch (device compute + transport)."),
    "compile": ("span",
                "One observed jit compilation (first invocation of a "
                "program signature)."),
    "decode_chunk": ("span", "One fused free-phase decode chunk (the "
                             "blocking host sync; dispatch is pipelined)."),
    "spec_step": ("span", "One speculative decode step."),
    "grammar_fused_chunk": ("span", "One fused grammar-constrained chunk."),
    "kv_spill": ("span", "One HBM -> host tier spill (gather + enqueue)."),
    "kv_fetch": ("span", "One host tier -> HBM streamed resume (fetch + "
                         "scatter)."),
    "agent.completion": ("span", "One LLM call from the assistant loop."),
    "provider.jax_local": ("span", "One local-engine provider call."),
    "tool.*": ("span", "One tool execution (per-tool family)."),
    "collective.*": ("span",
                     "Sharded decode-dispatch wall time attributed to one "
                     "active mesh axis (per-axis family; an upper bound "
                     "on that axis's collective time — the step includes "
                     "compute)."),
    # --- histograms (observed directly, not via span) -------------------
    "ttft_seconds": ("histogram",
                     "Time from submit to first emitted token."),
    "queue_wait_seconds": ("histogram",
                           "Time from submit to scheduler admission."),
    # --- the port's own names (the JAX package sets none of these) -----
    "kv.spill_skipped_length": (
        "counter", "Preemption victims not spilled because their device "
                   "length is not their host token count (they replay "
                   "instead); the JAX package skips them silently."),
    "scheduler.replayed_tokens": (
        "counter", "Delivered tokens re-emitted to a fresh consumer by a "
                   "restored request (warm restart, resurrection)."),
    "scheduler.dispatch_issue_seconds": (
        "counter", "Seconds the paged scheduler spent issuing decode "
                   "dispatches (each dispatch's call until its launches "
                   "were queued: the dispatch_issue span's interval)."),
    "scheduler.admit_seconds": (
        "counter", "Wall seconds of the paged scheduler's admission calls "
                   "(one a loop iteration; prefills included)."),
    "provider.torch_local": ("span", "One local-engine provider call "
                                     "(the port's provider.jax_local)."),
}


def declared(name: str) -> bool:
    """True if a call-site metric name is covered by the registry.

    ``name`` may itself contain ``*`` (the lint normalizes f-string
    ``{...}`` segments to ``*``), so match in both directions.
    """
    if name in METRIC_REGISTRY:
        return True
    return any(
        fnmatch(name, pat) or fnmatch(pat, name) for pat in METRIC_REGISTRY
    )


def help_for(name: str) -> tuple[str, str] | None:
    """(kind, help) for a concrete metric name; ``*_seconds`` histograms
    derived from spans resolve through their base span name."""
    if name in METRIC_REGISTRY:
        return METRIC_REGISTRY[name]
    for pat, info in METRIC_REGISTRY.items():
        if "*" in pat and fnmatch(name, pat):
            return info
    if name.endswith("_seconds"):
        base = help_for(name[: -len("_seconds")])
        if base is not None:
            return ("histogram", base[1] + " (latency histogram)")
    return None
