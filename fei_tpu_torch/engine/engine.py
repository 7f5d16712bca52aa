"""The dense inference engine: bucketed prefill + streaming decode
(counterpart of the dense half of fei_tpu/engine/engine.py).

- **Prefill** pads the prompt to a power-of-two bucket and runs one
  forward; on the card, prompt-sized T goes through the flash-attention
  kernel (models/llama.py ``_attend``).
- **Decode** is fused-chunked by default (engine/fused_decode.py): one host
  sync per ``chunk`` tokens with an on-device stop. ``chunk=1`` keeps the
  per-token loop, the in-tree parity oracle.
- **Sampling** runs on the device; only sampled ids cross to the host. A
  request's threefry key chain is the reference's: ``PRNGKey(seed)``,
  split once before the first token and once per sampled step
  (engine/prng.py), so a seeded request draws the JAX package's bits.
- **Static shapes**: the cache is a fixed [L, B, S, K, D] buffer with a
  valid length per sequence; prompt padding is never attended and is
  overwritten slot by slot during decode.

- **Paged** (``paged=True``): a shared page pool with continuous batching
  (engine/scheduler.py ``PagedScheduler``); every generation call goes
  through the scheduler, and concurrent callers share one batched decode.

- **Weight-only int8 / int4** (``quantize``): the big linears are
  quantized at init or while a checkpoint is read (``ops.quant``); int4
  products run the K4 kernel, dense and paged alike.

- **Prompt-lookup speculation** (``generate_stream_lookahead``, which
  greedy ``chat`` turns use): a repeated n-gram proposes the tokens that
  followed it, one forward of ``1 + draft_len`` tokens verifies them, and
  the cache's length is cut back to the accepted ones.

- **MoE** (Mixtral): the JAX engine's rule, ``routed = mesh is None``:
  on one device every dense forward lets its MoE layers take the
  token-routed form (``routed_moe=True``), which ``models.llama._moe``
  takes from ``_ROUTED_MIN_TOKENS`` tokens (prefill, verify blocks of
  16+); on a mesh they take the dense oracle, and on an ``ep`` mesh the
  expert-parallel route (``_moe_mesh``: ``parallel.expert.
  moe_mlp_ep_routed``, at ``FEI_TPU_EP_CAPACITY``).

- **Mesh** (``FEI_TPU_MESH=tp2|dp2|sp2|ep2|pp2|tp2ep2|auto`` or
  ``mesh=``): the engine spans ranks, one process each
  (parallel/serving.py). Rank 0 is this engine; ``from_config`` starts the
  followers, and each device call rank 0 makes runs on every rank's shard.
  ``FEI_TPU_MESH_WEIGHTS`` picks the weights profile: ``replicated`` (the
  environment mesh's default; streams bitwise the one-device engine's) or
  ``sharded`` (Megatron, experts over ep; an explicit mesh's default). A
  paged engine's slots multiply by dp. On an ``sp`` axis a prompt of at
  least ``long_prefill_min`` tokens (``FEI_TPU_LONG_PREFILL_MIN``, 2048)
  prefills sequence-sharded (``parallel.long_prefill``, ring or Ulysses
  by ``FEI_TPU_SP_ATTEND``); the pool and decode replicate over sp and pp,
  which no sharding table names.

- **Constrained tool calls** (``generate_constrained``,
  ``generate_stream_toolcalls``): the grammar's DFA steps on the device
  inside each decode chunk (``_grammar_fused_fn``: the state's table row,
  the budget-feasibility mask, the sample, the next state), so a
  constrained chunk syncs with the host once, like a free one. A free
  phase that finds the ``<tool_call>`` trigger mid-chunk rolls the cache
  and the key back to that token (``ChunkDecoder.rollback``).

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu") and
raises ``EngineError`` when CUDA is asked for and missing.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from fei_tpu_torch.engine.fused_decode import (
    ChunkDecoder,
    build_fused_decode,
    resolve_chunk,
    trigger_walk,
)
from fei_tpu_torch.engine import prng
from fei_tpu_torch.engine.sampling import sample_logits
from fei_tpu_torch.engine.tokenizer import load_tokenizer
from fei_tpu_torch.models.configs import ModelConfig, get_model_config
from fei_tpu_torch.models.llama import (
    QUANT_MODES,
    KVCache,
    _logits,
    forward,
    init_params,
)
from fei_tpu_torch.obs.flight import FLIGHT, CompileObserver
from fei_tpu_torch.parallel.mesh import axis_size, has_axis, mesh_geometry, mesh_tag
from fei_tpu_torch.parallel.serving import spmd_op
from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("engine")


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    min_p: float = 0.0  # drop tokens with prob < min_p * max-prob
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False  # benchmark mode: decode the full budget
    # free-phase fused decode chunk: 0 → FEI_TPU_DECODE_CHUNK (default 16),
    # 1 → per-token reference loop, N → N tokens per host sync
    chunk: int = 0
    # paged serving: a wall-clock budget from submit in seconds (0 → the
    # scheduler's default_deadline_s), and the tenant and priority class of
    # its weighted-fair admission ("" → the default tenant)
    deadline_s: float = 0.0
    tenant: str = ""
    priority: int = 0


@dataclass
class GenerationResult:
    token_ids: list[int]
    text: str
    ttft_s: float
    decode_tokens_per_s: float
    prompt_tokens: int


def _next_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_vocab_mask(mask, vocab_size: int) -> torch.Tensor | None:
    """Pad a tokenizer-vocab bool logit mask up to the model's (often
    larger) vocab; the padded slots are never legal. A mask WIDER than the
    model vocab means a tokenizer/model mismatch and raises."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask, dtype=torch.bool)
    if mask.shape[-1] > vocab_size:
        raise EngineError(
            f"logit mask width {mask.shape[-1]} exceeds model vocab "
            f"{vocab_size}; tokenizer and model vocabularies are inconsistent"
        )
    if mask.shape[-1] < vocab_size:
        mask = torch.nn.functional.pad(mask, (0, vocab_size - mask.shape[-1]))
    return mask


def _split_if_sampled(gen: GenerationConfig, key: torch.Tensor):
    """``(key, sub)`` = the reference's ``rng, sub = split(rng)`` for a
    sampled request; a greedy one draws nothing and keeps its key."""
    if gen.temperature > 0.0:
        nk, sub = prng.split(key)
        return nk, sub
    return key, None


def resolve_device(device: torch.device | str) -> torch.device:
    """The engine's device; asking for CUDA without a card is an error,
    never a quiet move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EngineError(
            "CUDA is not available: fei_tpu_torch runs on an NVIDIA GPU "
            "unless the caller passes device='cpu'"
        )
    return dev


@spmd_op(creates=True)
def new_kv_cache(eng, batch: int, max_seq: int, kernel_mesh=None) -> KVCache:
    """A zeroed dense cache of ``eng``; under a mesh, this rank's shard of
    it (``parallel.sharding.cache_shardings``: its kv heads, and its rows
    where the batch divides dp)."""
    shape = None
    if kernel_mesh is not None:
        from fei_tpu_torch.parallel.sharding import cache_shardings

        cfg = eng.cfg
        whole = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim_)
        shape = cache_shardings(kernel_mesh, batch).k.local_shape(whole)
    return KVCache.create(eng.cfg, batch, max_seq, dtype=eng.dtype, device=eng.device,
                          shape=shape)


@spmd_op(creates=True)
def new_page_pool(eng, num_pages: int, batch: int, table_width: int, kernel_mesh=None):
    """A zeroed page pool of ``eng``; under a mesh, this rank's kv heads
    of it (``parallel.sharding.paged_pool_specs``)."""
    from fei_tpu_torch.engine.paged_cache import PagedKVCache

    return PagedKVCache.create(
        eng.cfg, num_pages, batch, table_width, page_size=eng.page_size,
        dtype=eng.dtype, kv_quant=eng.kv_quant, device=eng.device,
        num_kv_heads=eng.cfg.num_kv_heads // axis_size(kernel_mesh, "tp"),
    )


@spmd_op
@torch.no_grad()
def sp_prefill(eng, padded, true_len, cache, attend: str = "ring", kernel_mesh=None):
    """Sequence-sharded prefill into ``cache`` (this rank's shard of it):
    every rank runs ``prefill_ring_kv`` on its chunk of ``padded`` [B, T],
    and the gathered K/V land in its cache. Returns (last-valid logits
    [B, V] fp32, the cache with length ``true_len``)."""
    from fei_tpu_torch.parallel.long_prefill import prefill_ring_kv

    logits, k_all, v_all = prefill_ring_kv(eng.params, eng.cfg, padded, kernel_mesh,
                                           true_len=true_len, attend=attend)
    T = padded.shape[1]
    if cache.k.shape[1] != k_all.shape[1]:  # the rank's dp rows of the batch
        n, r = cache.k.shape[1], kernel_mesh.coords["dp"]
        k_all, v_all = k_all[:, r * n:(r + 1) * n], v_all[:, r * n:(r + 1) * n]
    cache.k[:, :, :T] = k_all.to(cache.k.dtype)
    cache.v[:, :, :T] = v_all.to(cache.v.dtype)
    return logits, cache._replace(length=true_len.to(device=cache.length.device,
                                                      dtype=torch.int32))


def _resolve_mesh(mesh, cfg, device):
    """``(mesh or None, from_env)``: ``mesh=None`` reads ``FEI_TPU_MESH``;
    a spec string is parsed; a ``Mesh`` passes. One rank is no mesh. With
    a default process group initialized, an unbound mesh binds to it."""
    import torch.distributed as dist

    from fei_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_env

    from_env = mesh is None
    if from_env:
        mesh = mesh_from_env(num_kv_heads=cfg.num_kv_heads, num_experts=cfg.num_experts)
    elif isinstance(mesh, str):
        mesh = mesh_from_env(num_kv_heads=cfg.num_kv_heads, num_experts=cfg.num_experts,
                             env=mesh or "ms1")
    elif not isinstance(mesh, Mesh):
        raise EngineError(f"mesh must be a Mesh, a spec or None, not {type(mesh).__name__}")
    if mesh is None or mesh.size == 1:
        return None, from_env
    if mesh.shape["tp"] > 1 and cfg.num_kv_heads % mesh.shape["tp"]:
        raise EngineError(f"tp={mesh.shape['tp']} must divide the model's "
                          f"{cfg.num_kv_heads} kv heads")
    if not mesh.bound and dist.is_available() and dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(mesh.shape, device=device)
    return mesh, from_env


class InferenceEngine:
    def __init__(
        self,
        model_cfg: ModelConfig,
        params: dict,
        tokenizer,
        max_seq_len: int | None = None,
        batch_size: int = 1,
        dtype=torch.bfloat16,
        device: torch.device | str = "cuda",
        paged: bool = False,
        page_size: int = 64,
        num_pages: int | None = None,
        kv_quant: str | None = None,
        prefix_cache: bool = False,
        mesh=None,
        long_prefill_min: int | None = None,
    ):
        self.cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        # the serving mesh (a bound parallel.mesh.Mesh) or None; a follower
        # rank's engine has no scheduler (rank 0 schedules for the mesh)
        self.mesh = mesh
        self.mesh_tag = mesh_tag(mesh)
        self.mesh_weights = None
        self._spmd_leader = None
        self.max_seq_len = max_seq_len or model_cfg.max_seq_len
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = resolve_device(device)
        # first builds this engine caused: its grammar table uploads (the
        # kernel libraries, process-wide, count in ops/kernels/build.py)
        self._compiles = CompileObserver()
        self._pending_prefill: tuple | None = None  # (t0, t_issue, tokens)
        self.paged = paged
        self.page_size = page_size
        self.num_pages = num_pages  # None: worst case for batch_size sequences
        # "int8": paged pools store int8 + per-slot scales (half the KV bytes)
        if kv_quant not in (None, "int8"):
            raise EngineError(f"unsupported kv_quant mode: {kv_quant!r}")
        if kv_quant and not paged:
            raise EngineError("kv_quant requires paged=True (the contiguous "
                              "KVCache path has no quantized layout)")
        if prefix_cache and not paged:
            raise EngineError("prefix_cache requires paged=True (prefixes are "
                              "reused as shared pages of the paged pool)")
        self.kv_quant = kv_quant
        self.prefix_cache = prefix_cache
        self._pool = None  # lazy PagedKVCache
        self._allocator = None
        # prompts at least this long prefill sequence-sharded over the
        # mesh's sp axis (parallel.long_prefill) instead of in one forward
        self.long_prefill_min = long_prefill_min if long_prefill_min is not None \
            else int(os.environ.get("FEI_TPU_LONG_PREFILL_MIN", "2048"))
        self._sp_prefill_call = None  # the sp prefill op with its attend resolved
        self._scheduler = None
        if paged and (mesh is None or mesh.rank == 0):
            from fei_tpu_torch.engine.scheduler import PagedScheduler

            self._scheduler = PagedScheduler(self)

    @property
    def tp(self) -> int:
        """The tensor-parallel degree (1 without a mesh)."""
        return axis_size(self.mesh, "tp")

    def _moe_mesh(self):
        """The mesh for token-routed expert parallelism inside the model
        forward, or None without an ep axis (one device, tp/dp meshes)."""
        if self.cfg.is_moe and has_axis(self.mesh, "ep"):
            return self.mesh
        return None

    def _fwd_kw(self) -> dict:
        """The MoE routing of this engine's dense forwards: the JAX
        engine's ``routed = mesh is None`` (an ep mesh owns its routing,
        any other mesh takes the oracle) and its ``_moe_mesh``."""
        return dict(routed_moe=self.mesh is None, moe_mesh=self._moe_mesh())

    # -- construction -------------------------------------------------------

    @classmethod
    def from_config(
        cls,
        name: str,
        *,
        dtype=torch.bfloat16,
        seed: int = 0,
        tokenizer: str | None = "byte",
        checkpoint_dir: str | None = None,
        max_seq_len: int | None = None,
        batch_size: int = 1,
        device: torch.device | str = "cuda",
        paged: bool = False,
        page_size: int = 64,
        num_pages: int | None = None,
        quantize: str | None = None,
        kv_quant: str | None = None,
        prefix_cache: bool = False,
        params: dict | None = None,
        int4_lm_head: bool | None = None,
        quant_embed: bool | None = None,
        mesh=None,
        mesh_weights: str | None = None,
        long_prefill_min: int | None = None,
        **overrides,
    ) -> "InferenceEngine":
        """Random-init (from ``seed``, on ``device``) or checkpoint weights;
        ``params`` hands over an existing parameter dict instead (engines
        sharing weights). ``quantize`` ("int8" or "int4") quantizes the big
        linears as they are made or read; ``int4_lm_head`` puts the LM head
        in int4 too and ``quant_embed`` row-quantizes the embedding table
        (None, the default: as ``FEI_TPU_INT4_LM_HEAD`` /
        ``FEI_TPU_QUANT_EMBED`` say, read where the JAX package reads them).

        ``mesh``: None reads ``FEI_TPU_MESH``; a spec ("tp2", "tp2dp2",
        "dp=2,tp=2") or a ``parallel.mesh.Mesh``. A mesh of more than one
        rank starts its follower ranks (``parallel.serving.launch``), or,
        with a process group already initialized, binds to it. On rank 0
        this returns the serving engine; on a follower rank it serves rank
        0's dispatches and returns when rank 0 closes its engine.
        ``mesh_weights`` ("replicated" | "sharded") overrides
        ``FEI_TPU_MESH_WEIGHTS``; the default is "replicated" for the
        environment's mesh and "sharded" for an explicit one. Under a tp
        mesh, int4 keeps the row-parallel ``wo``/``w_down`` int8."""
        if quantize not in QUANT_MODES:
            raise EngineError(
                f"unsupported quantize mode {quantize!r}; one of "
                f"{[m for m in QUANT_MODES if m]} (or unset)"
            )
        dev = resolve_device(device)
        cfg = get_model_config(name, **overrides)
        mesh, from_env = _resolve_mesh(mesh, cfg, dev)
        weights = None
        slots = batch_size
        if mesh is not None:
            import os

            from fei_tpu_torch.parallel.sharding import rules_for

            weights = mesh_weights or os.environ.get(
                "FEI_TPU_MESH_WEIGHTS", "replicated" if from_env else "sharded")
            rules_for(weights, cfg.is_moe)  # an unknown profile raises here
            if paged:
                # dp groups multiply the decode slots: each serves batch_size
                slots = batch_size * axis_size(mesh, "dp")
            if not mesh.bound:
                from fei_tpu_torch.parallel.serving import launch

                mesh = launch(mesh.shape, dev, name, dict(
                    dtype=dtype, seed=seed, tokenizer=tokenizer,
                    checkpoint_dir=checkpoint_dir, max_seq_len=max_seq_len,
                    batch_size=batch_size, paged=paged, page_size=page_size,
                    num_pages=num_pages, quantize=quantize, kv_quant=kv_quant,
                    prefix_cache=prefix_cache, params=params,
                    int4_lm_head=int4_lm_head, quant_embed=quant_embed,
                    mesh_weights=weights, long_prefill_min=long_prefill_min,
                    **overrides))
            dev = mesh.device
        qkw = dict(quantize=quantize, int4_lm_head=int4_lm_head, quant_embed=quant_embed)
        if quantize == "int4" and axis_size(mesh, "tp") > 1:
            # tp splits the row-parallel linears' contraction, which nibble
            # pairs span: they stay int8 (the reference's int4_exclude)
            qkw["int4_exclude"] = frozenset({"wo", "w_down"})
        tok = load_tokenizer(tokenizer)
        loaded = False
        if params is None and checkpoint_dir:
            from fei_tpu_torch.engine.weights import load_checkpoint

            # under a mesh each rank reads only its slices of each tensor
            cfg, params = load_checkpoint(checkpoint_dir, cfg, dtype=dtype, device=dev,
                                          mesh=mesh, weights=weights, **qkw)
            loaded = True
        elif params is None:
            params = init_params(cfg, seed=seed, dtype=dtype, device=dev, **qkw)
        elif mesh is not None:
            from fei_tpu_torch.utils.tree import tree_map

            params = tree_map(lambda t: type(t)(*(f.to(dev) for f in t))
                              if isinstance(t, tuple) else t.to(dev), params)
        engine = cls(
            cfg, params, tok, max_seq_len=max_seq_len, batch_size=slots,
            dtype=dtype, device=dev, paged=paged, page_size=page_size,
            num_pages=num_pages, kv_quant=kv_quant, prefix_cache=prefix_cache,
            mesh=mesh, long_prefill_min=long_prefill_min,
        )
        if mesh is None:
            return engine
        from fei_tpu_torch.parallel.serving import Leader, follow
        from fei_tpu_torch.parallel.sharding import shard_engine

        if loaded:
            engine.mesh_weights = weights  # the params landed sharded
        else:
            shard_engine(engine, mesh, weights=weights)
        if mesh.rank != 0:
            follow(engine, mesh)
            return engine
        Leader(engine, mesh)
        log.info("engine %s on mesh %s (%s weights), rank 0 on %s over %s",
                 cfg.name, engine.mesh_tag, weights, dev, mesh.backend)
        return engine

    # -- paged pool ---------------------------------------------------------

    def _ensure_pool(self):
        """Lazily create the shared page pool + allocator (paged mode). The
        default pool holds ``batch_size`` full-length sequences plus the
        null page; ``num_pages`` sizes it to a memory budget instead."""
        from fei_tpu_torch.engine.paged_cache import PageAllocator

        table_width = -(-self.max_seq_len // self.page_size)
        num_pages = self.num_pages or (self.batch_size * table_width + 1)
        if self._pool is None:
            self._pool = new_page_pool(self, num_pages, self.batch_size, table_width)
        if self._allocator is None:
            self._allocator = PageAllocator(num_pages, self.page_size)
        return self._pool

    def kv_fingerprint(self) -> dict | None:
        """The INVARIANT half of this engine's KV pool geometry (layers,
        total kv heads, page_size, head_dim, dtype, quantized) that
        ``/health`` advertises: equal to the JAX package's for the same
        model and knobs. None for a dense engine. Derived from the config
        until the scheduler's pool exists (a health probe must not race
        the loop thread that builds it)."""
        if self._scheduler is None:
            return None
        from fei_tpu_torch.kv.pagesio import config_fingerprint, pool_fingerprint

        pool = self._scheduler._pool
        if pool is not None:
            return pool_fingerprint(pool, self.tp)
        return config_fingerprint(self.cfg, self.page_size, self.dtype, self.kv_quant)

    def kv_layout(self) -> dict | None:
        """The LAYOUT half: how the kv-head extent is sliced over tp. None
        for a dense engine."""
        if self._scheduler is None:
            return None
        from fei_tpu_torch.kv.pagesio import shard_layout

        return shard_layout(self.cfg.num_kv_heads, self.tp)

    @property
    def scheduler(self):
        """The continuous-batching scheduler; all paged generation runs
        through it."""
        if self._scheduler is None:
            raise EngineError(
                "this engine was not constructed with paged=True; the decode "
                "scheduler only exists for paged engines"
            )
        return self._scheduler

    def close(self) -> None:
        """Stop the paged scheduler's loop thread (a dense engine has none)
        and flush its session journal; on a mesh, then stop the follower
        ranks (the engine serves no more calls)."""
        if self._scheduler is not None:
            self._scheduler.close()
        if self._spmd_leader is not None:
            self._spmd_leader.stop()

    # -- survival ------------------------------------------------------------

    def begin_drain(self, deadline_s: float | None = None,
                    snapshot_dir: str | None = None) -> None:
        """Graceful drain (SIGTERM / POST /drain): reject new submits with
        EngineDrainingError, let in-flight requests finish within the
        deadline, snapshot the rest for a warm restart. A dense engine has
        nothing in flight to drain."""
        if self._scheduler is not None:
            self._scheduler.begin_drain(deadline_s=deadline_s, snapshot_dir=snapshot_dir)

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until a drain finalized (trivially true without a
        scheduler)."""
        if self._scheduler is None:
            return True
        return self._scheduler.wait_drained(timeout)

    def warm_restart(self, snapshot_dir: str | None = None) -> list:
        """Re-admit the in-flight work a previous process left behind, from
        two sources:

        - drain snapshots in ``snapshot_dir`` (a graceful drain). The file
          is cleared BEFORE re-admission: a crash mid-replay must not
          serve a request twice.
        - the session journal (``FEI_TPU_JOURNAL_DIR``, a hard crash): the
          admitted-but-unfinished sessions of older segments, which are
          deleted before re-admission (the re-admissions journal into the
          live segment).

        A session recorded under another ``page_size`` or past its
        deadline is skipped and counted in
        ``engine.recovery_skipped.<reason>``; one from another mesh is
        accepted (the mesh is provenance). Each restored request replays
        its delivered tokens to the new consumer, so the stream equals
        the uninterrupted run. Returns the sequence handles (stream each
        with ``scheduler.drain(seq)``)."""
        from fei_tpu_torch.engine.checkpoint import (
            clear_request_snapshots,
            load_request_snapshots,
        )
        from fei_tpu_torch.engine.journal import deadline_remaining
        from fei_tpu_torch.engine.scheduler import gen_from_record

        seqs: list = []
        snaps: list[dict] = []
        if snapshot_dir:
            snaps = load_request_snapshots(
                snapshot_dir, expect_mesh=mesh_geometry(self.mesh),
                expect_page_size=self.page_size)
            if snaps:
                clear_request_snapshots(snapshot_dir)
                seqs.extend(self.scheduler.restore_snapshots(snaps))
        journal = None if self._scheduler is None else self._scheduler._journal
        if journal is None:
            return seqs
        sessions, torn = journal.recover_and_clear()
        snap_rids = {s.get("rid") for s in snaps}
        recovered = cross_mesh = 0
        mesh_now = mesh_geometry(self.mesh)
        for sess in sessions:
            rid = sess.get("rid")
            if rid in snap_rids:
                continue  # the drain snapshot owns this session
            saved_ps = sess.get("page_size")
            if saved_ps is not None and int(saved_ps) != self.page_size:
                METRICS.incr("engine.recovery_skipped.page_size")
                FLIGHT.event("recovery_skip", rid=rid, reason="page_size", saved=int(saved_ps))
                log.warning("journal session %s was served under page_size=%s, not "
                            "this engine's %s; dropping it", rid, saved_ps, self.page_size)
                continue
            mesh = {k: int(v) for k, v in (sess.get("mesh") or {}).items()}
            if mesh != mesh_now:
                cross_mesh += 1  # provenance only: replayed like any other
            restore = {"generated": sess.get("generated") or [],
                       "resume_key": sess.get("resume_key"),
                       "route": sess.get("route")}
            if sess.get("deadline_epoch") is not None:
                rem = deadline_remaining(sess["deadline_epoch"])
                if rem <= 0:
                    METRICS.incr("engine.recovery_skipped.deadline_expired")
                    FLIGHT.event("recovery_skip", rid=rid, reason="deadline_expired")
                    log.info("journal session %s expired its deadline during the "
                             "outage; dropping it", rid)
                    continue
                restore["deadline_remaining_s"] = rem
            seqs.append(self.scheduler.submit(
                sess["prompt_ids"], gen_from_record(sess.get("gen")), _restore=restore))
            recovered += 1
        if recovered:
            METRICS.incr("journal.recovered_sessions", recovered)
            METRICS.incr("engine.crash_recoveries")
        if cross_mesh:
            METRICS.incr("engine.cross_mesh_recoveries", cross_mesh)
        if sessions or torn:
            log.info("journal: recovered %d session(s), %d from another mesh "
                     "(%d torn record(s) discarded)", recovered, cross_mesh, torn)
        return seqs

    # -- device programs ----------------------------------------------------

    def _step(self, gen: GenerationConfig, cache, token, key, logit_mask=None):
        """One decode step: forward T=1, optional mask, split the key and
        sample on device. Returns (next_token [B] int32, cache, key)."""
        logits, cache = forward(self.params, self.cfg, token, cache, **self._fwd_kw())
        logits = logits[:, -1, :]
        if logit_mask is not None:
            logits = torch.where(logit_mask, logits, float("-inf"))
        key, sub = _split_if_sampled(gen, key)
        nxt = sample_logits(
            logits, sub, temperature=gen.temperature, top_k=gen.top_k,
            top_p=gen.top_p, min_p=gen.min_p,
        )
        return nxt, cache, key

    def _free_fused_fn(self, gen: GenerationConfig, n_steps: int) -> Callable:
        """The N-step fused free-decode function (fused_decode)."""
        return build_fused_decode(functools.partial(forward, **self._fwd_kw()),
                                  self.cfg, gen, n_steps)

    def _grammar_fused_fn(self, gen: GenerationConfig, n_steps: int) -> Callable:
        """Constrained fused decode: the grammar's DFA steps on the device
        inside the chunk — row = table[state], the budget-feasibility mask
        on the logits, the sample, state' = row[token] — so a constrained
        chunk of ``n_steps`` tokens makes no host sync of its own.

        Returns ``fused(params, cache, token, key, gstate, remaining,
        table, min_dist)`` → ``(toks [B, n], cache, token [B, 1], key,
        gstate, remaining)``; ``key`` is the threefry key (split once per
        sampled step), ``gstate`` int32 [B], ``remaining`` an int32
        tensor, ``table`` int16/int32 [S, V] and ``min_dist`` int32 [S],
        all on the engine's device."""
        from fei_tpu_torch.engine.grammar import grammar_step

        temperature, top_k, top_p, min_p = (
            gen.temperature, gen.top_k, gen.top_p, gen.min_p
        )
        cfg = self.cfg
        fwd_kw = self._fwd_kw()

        def fused(params, cache, token, key, gstate, remaining, table, min_dist):
            toks = []
            for _ in range(n_steps):
                logits, cache = forward(params, cfg, token, cache, **fwd_kw)
                logits, advance = grammar_step(
                    logits[:, -1, :], table, min_dist, gstate, remaining)
                key, sub = _split_if_sampled(gen, key)
                nxt = sample_logits(
                    logits, sub, temperature=temperature, top_k=top_k,
                    top_p=top_p, min_p=min_p,
                )
                gstate, remaining = advance(nxt)
                token = nxt[:, None]
                toks.append(nxt)
            return torch.stack(toks, dim=1), cache, token, key, gstate, remaining

        return fused

    # -- generation ---------------------------------------------------------

    def new_cache(self, batch: int | None = None, max_seq: int | None = None) -> KVCache:
        """A zeroed dense cache (``max_seq`` defaults to the engine's);
        under a mesh every rank allocates its shard."""
        return new_kv_cache(self, batch or self.batch_size, max_seq or self.max_seq_len)

    def _pad_mask(self, mask) -> torch.Tensor | None:
        mask = pad_vocab_mask(mask, self.cfg.vocab_size)
        return None if mask is None else mask.to(self.device)

    def _stops(self, gen: GenerationConfig) -> set[int]:
        if gen.ignore_eos:
            return set()
        return set(gen.stop_token_ids) | set(self.tokenizer.stop_token_ids)

    def _sp_prefill_eligible(self, n_tokens: int) -> bool:
        """True when this prompt WILL prefill sequence-sharded: the mesh has
        a real sp axis, the prompt meets ``long_prefill_min`` and the padded
        bucket divides over the axis. One guard shared by ``prefill`` and
        the scheduler's admission, so the two never disagree."""
        if not has_axis(self.mesh, "sp") or n_tokens < self.long_prefill_min:
            return False
        bucket = min(_next_bucket(n_tokens), self.max_seq_len)
        return bucket % self.mesh.shape["sp"] == 0

    def _sp_prefill_fn(self):
        """The sequence-sharded prefill op (``sp_prefill``), with
        ``FEI_TPU_SP_ATTEND`` resolved once: ``ring`` (default: K/V chunks
        rotate) or ``ulysses`` (head↔seq all_to_all). An unknown value, or
        Ulysses over heads that do not divide sp, logs a warning and takes
        ring. Registered with the engine's compile observer as
        ``engine.sp_prefill``."""
        if self._sp_prefill_call is None:
            cfg = self.cfg
            attend = os.environ.get("FEI_TPU_SP_ATTEND", "ring").strip().lower()
            if attend not in ("ring", "ulysses"):
                log.warning("unknown FEI_TPU_SP_ATTEND=%r (ring | ulysses); using ring",
                            attend)
                attend = "ring"
            n, tp = self.mesh.shape["sp"], self.tp  # a rank scatters its tp heads
            if attend == "ulysses" and ((cfg.num_heads // tp) % n
                                        or (cfg.num_kv_heads // tp) % n):
                log.warning("FEI_TPU_SP_ATTEND=ulysses needs heads divisible by sp=%d "
                            "(H=%d, K=%d); using ring", n, cfg.num_heads, cfg.num_kv_heads)
                attend = "ring"
            self._sp_prefill_call = self._compiles.wrap(
                "engine.sp_prefill", "sp", functools.partial(sp_prefill, attend=attend))
        return self._sp_prefill_call

    def prefill(
        self, prompt_ids: Sequence[Sequence[int]], cache: KVCache,
        flash: bool | None = None,
    ):
        """Pad prompts to a bucket, run one forward, fix cache lengths.
        Returns (last_valid_logits [B, V] float32, cache). Only the last
        valid position goes through the LM head. ``flash`` picks the
        attention path (None: the kernel for prompt-sized T on the card).

        Long prompts (>= ``long_prefill_min``) on a mesh with an sp axis
        prefill sequence-sharded: the whole model over ring or Ulysses
        attention (``parallel.long_prefill``), each rank holding T/n
        tokens; the cache it returns has the same contract. While the
        flight recorder captures, the call is an ``engine.prefill`` range."""
        if not FLIGHT.capturing:
            return self._prefill(prompt_ids, cache, flash)
        r = FLIGHT.open("engine.prefill", rows=len(prompt_ids))
        try:
            return self._prefill(prompt_ids, cache, flash)
        finally:
            FLIGHT.close(r)

    def _prefill(self, prompt_ids, cache: KVCache, flash: bool | None):
        B = len(prompt_ids)
        lengths = [len(p) for p in prompt_ids]
        max_len = max(lengths)
        if max_len > self.max_seq_len:
            raise EngineError(
                f"prompt length {max_len} exceeds engine max_seq_len {self.max_seq_len}"
            )
        bucket = min(_next_bucket(max_len), self.max_seq_len)
        padded = torch.tensor(
            [list(p) + [0] * (bucket - n) for p, n in zip(prompt_ids, lengths)],
            dtype=torch.long, device=self.device,
        )
        true_len = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        if self._sp_prefill_eligible(max_len) and cache.k.shape[2] >= bucket:
            METRICS.incr("engine.sp_prefills")
            with METRICS.span("prefill_sp", nvtx=True):
                return self._sp_prefill_fn()(self, padded, true_len, cache)
        hidden, cache = forward(
            self.params, self.cfg, padded, cache, lm_head=False, flash=flash,
            **self._fwd_kw(),
        )
        # padding wrote garbage kv beyond each true length; resetting the
        # length masks it out of attention and decode overwrites it
        cache = cache._replace(length=true_len)
        last = hidden[torch.arange(B, device=self.device), true_len.long() - 1]
        return _logits(last, self.params, self.cfg), cache

    def _prefill_sample(self, prompt_ids, gen: GenerationConfig, mask=None):
        """Shared prologue: prefill, optional first-token logit mask,
        sample. Returns (tok [1] int32, cache, key): the key is
        ``PRNGKey(seed)`` after the first token's split. The flight record
        of the prefill waits for the caller's host copy of the token
        (``_host_first``): the prologue adds no sync of its own."""
        t0 = time.time()
        with METRICS.span("prefill", nvtx=True):
            last_logits, cache = self.prefill([list(prompt_ids)], self.new_cache(1))
            if mask is not None:
                last_logits = torch.where(mask[None, :], last_logits, float("-inf"))
            key, sub = _split_if_sampled(gen, prng.PRNGKey(gen.seed, self.device))
            tok = sample_logits(
                last_logits, sub, temperature=gen.temperature,
                top_k=gen.top_k, top_p=gen.top_p, min_p=gen.min_p,
            )
        self._pending_prefill = (t0, time.time(), len(prompt_ids))
        return tok, cache, key

    def _host_first(self, tok) -> int:
        """The first token on the host: the prefill's one host copy, which
        closes its flight record (issue return → sync)."""
        first = int(tok[0])
        pending, self._pending_prefill = self._pending_prefill, None
        if pending is not None:
            t0, t_issue, n = pending
            FLIGHT.dispatch("dispatch.prefill", t0, t_issue, time.time(),
                            mesh=self.mesh_tag, tokens=n)
        return first

    def _make_result(
        self, out: list[int], prompt_len: int, ttft: float, total: float
    ) -> GenerationResult:
        decode_s = total - ttft
        tps = (len(out) - 1) / decode_s if len(out) > 1 and decode_s > 0 else 0.0
        METRICS.gauge("last_ttft_s", ttft)
        METRICS.gauge("last_decode_tok_s", tps)
        METRICS.observe("ttft_seconds", ttft)
        return GenerationResult(
            token_ids=out,
            text=self.tokenizer.decode(out),
            ttft_s=ttft,
            decode_tokens_per_s=tps,
            prompt_tokens=prompt_len,
        )

    def generate_stream(
        self,
        prompt_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        logit_mask_fn: Callable[[list[int]], object] | None = None,
        export: dict | None = None,
        resume: dict | None = None,
    ) -> Iterator[int]:
        """Stream sampled token ids for a single prompt (batch=1).

        ``logit_mask_fn`` maps the tokens generated so far to a bool [V]
        mask of allowed next tokens (or None); it forces the per-token
        loop, since the mask needs every token on the host. Unmasked
        decoding is fused-chunked (``gen.chunk``; 1 = per-token loop).
        ``export`` (paged engines; see ``PagedScheduler.submit``) receives
        each delivered token's id and key, the SSE stream's failover
        channel; ``resume`` (``generated`` and an optional ``resume_key``)
        teacher-forces an already-delivered suffix, replayed first; paged
        engines only, as in the JAX package."""
        gen = gen or GenerationConfig()
        if self.paged:
            # continuous batching: the scheduler admits this request into a
            # batch slot; concurrent streams share the pool and the steps
            yield from self.scheduler.stream(prompt_ids, gen, logit_mask_fn,
                                             export=export, resume=resume)
            return
        if resume is not None:
            raise EngineError(
                "mid-stream resume requires a paged engine (the dense path "
                "keeps no session state to resume from)")
        if logit_mask_fn is None and resolve_chunk(gen.chunk) > 1:
            yield from self._stream_chunked(prompt_ids, gen, resolve_chunk(gen.chunk))
            return
        stops = self._stops(gen)
        generated: list[int] = []
        mask = self._pad_mask(logit_mask_fn(generated)) if logit_mask_fn else None
        # never decode past the cache: each step writes one KV slot
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        tok, cache, key = self._prefill_sample(prompt_ids, gen, mask)
        tok_host = self._host_first(tok)
        for i in range(budget):
            if tok_host in stops:
                break
            generated.append(tok_host)
            yield tok_host
            if i == budget - 1:
                break  # cache full: no step whose KV slot does not exist
            mask = self._pad_mask(logit_mask_fn(generated)) if logit_mask_fn else None
            t0 = time.time()
            with METRICS.span("decode_step"):
                METRICS.incr("engine.decode_dispatches")
                tok, cache, key = self._step(
                    gen, cache, tok.reshape(1, 1), key,
                    None if mask is None else mask[None, :],
                )
                t_issue = time.time()
                tok_host = int(tok[0])  # host sync inside the span
            FLIGHT.dispatch("dispatch.decode", t0, t_issue, time.time(),
                            mesh=self.mesh_tag, n_steps=1, slots=1)

    def _stream_chunked(
        self, prompt_ids: Sequence[int], gen: GenerationConfig, chunk: int
    ) -> Iterator[int]:
        """Fused chunked free decode: software-pipelined ChunkDecoder
        dispatches, host truncation at stops and budget."""
        stops = self._stops(gen)
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        tok, cache, key = self._prefill_sample(prompt_ids, gen)
        first = self._host_first(tok)
        if budget <= 0 or first in stops:
            return
        yield first
        if budget == 1:
            return
        dec = ChunkDecoder(
            self, gen, cache, tok, key,
            fed=len(prompt_ids), chunk=chunk, want=budget - 1, stops=stops,
        )
        emitted = 1
        for ch in dec.chunks():
            for t in ch.tokens:
                if t in stops:
                    return
                yield t
                emitted += 1
                if emitted >= budget:
                    return

    def generate_constrained(
        self,
        prompt_ids: Sequence[int],
        grammar,
        gen: GenerationConfig | None = None,
        chunk: int = 32,
    ) -> GenerationResult:
        """Grammar-constrained generation with the DFA on the device.

        ``grammar`` is a TokenGrammar (engine.grammar). The output equals
        ``generate(..., logit_mask_fn=grammar.logit_mask_fn(max_tokens=...))``,
        but the mask and the state step run inside the fused chunk: one
        host read per chunk instead of one per token. A paged engine runs
        it in the scheduler, batched with every other request."""
        gen = gen or GenerationConfig()
        if self.paged:
            return self._collect(
                self.scheduler.stream(prompt_ids, gen, grammar=grammar), len(prompt_ids))
        from fei_tpu_torch.engine.grammar import feasible_mask

        stops = self._stops(gen)
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        t0 = time.perf_counter()
        table, min_dist = grammar.device_tables(self.cfg.vocab_size, self.device,
                                                observer=self._compiles)
        # first token: the prefill logits masked by the entry row, with the
        # budget-feasibility rule the device steps apply
        entry_mask = self._pad_mask(
            feasible_mask(grammar.table[grammar.entry], grammar.min_dist, budget))
        tok, cache, key = self._prefill_sample(prompt_ids, gen, entry_mask)
        slots_left = self.max_seq_len - len(prompt_ids) - 1
        first = self._host_first(tok)
        ttft = time.perf_counter() - t0
        out: list[int] = []
        if budget > 0 and first not in stops:
            out.append(first)
            gstate = torch.tensor([grammar.walk([first])], dtype=torch.int32,
                                  device=self.device)
            remaining = torch.tensor(budget - 1, dtype=torch.int32, device=self.device)
            token = tok.reshape(1, 1)
            # software-pipelined: chunk k+1 is issued before chunk k's
            # tokens are read back for the stop check; on a stop the chunk
            # in flight is abandoned with the cache that dies with this call
            want = budget - 1
            sched = 0
            pending = None
            stopped = False
            while True:
                nxt = None
                if not stopped and sched < want and slots_left > 0:
                    n = min(chunk, slots_left)
                    fused = self._grammar_fused_fn(gen, n)
                    METRICS.incr("engine.decode_dispatches")
                    toks, cache, token, key, gstate, remaining = fused(
                        self.params, cache, token, key, gstate, remaining,
                        table, min_dist,
                    )
                    slots_left -= n
                    sched += n
                    nxt = (toks, n)
                if pending is None and nxt is None:
                    break
                if pending is not None:
                    toks_p, n_p = pending
                    host = toks_p[0].tolist()
                    METRICS.incr("engine.grammar_fused_steps", n_p)
                    emit = min(n_p, want - (len(out) - 1))
                    for t in host[:emit]:
                        if t in stops:
                            stopped = True
                            break
                        out.append(t)
                    if stopped:
                        break
                pending = nxt
        total = time.perf_counter() - t0
        return self._make_result(out, len(prompt_ids), ttft, total)

    def generate_stream_toolcalls(
        self,
        prompt_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        grammar=None,
        trigger: str = "<tool_call>",
        close: str = "</tool_call>",
        chunk: int = 16,
    ) -> Iterator[int]:
        """Stream an agent turn with the tool-call grammar enforced on the
        device.

        Free decoding runs until the generated text emits ``trigger``; the
        stream then switches to the fused grammar decode
        (``_grammar_fused_fn``) on the same cache until the DFA accepts a
        complete ``{"name":...,"arguments":{...}}`` object. The close tag's
        ids are then yielded (not fed back: the turn ends at ``tool_use``
        and the next turn prefills the conversation again) and the stream
        ends. ``grammar`` is the registry-union TokenGrammar
        (grammar.compile_agent_tool_grammar). A paged engine runs the same
        protocol inside the scheduler."""
        gen = gen or GenerationConfig()
        if grammar is None:
            yield from self.generate_stream(prompt_ids, gen)
            return
        from fei_tpu_torch.engine.grammar import TriggerScanner

        close_ids = self.tokenizer.encode(close)
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        if self.paged:
            seq = self.scheduler.submit(prompt_ids, gen, grammar=grammar,
                                        grammar_trigger=trigger)
            yield from self.scheduler.drain(seq)
            if seq.gaccepted:
                yield from close_ids
            return

        stops = self._stops(gen)
        scanner = TriggerScanner(self.tokenizer, trigger)
        tok, cache, key = self._prefill_sample(prompt_ids, gen)
        gstate = -1
        i = 0
        token = tok.reshape(1, 1)
        free_chunk = resolve_chunk(gen.chunk)
        if free_chunk > 1:
            # free phase, fused-chunked: the host TriggerScanner reads each
            # chunk while the next one computes; a mid-chunk trigger rolls
            # the cache and key back to the exact token and enters
            # the constrained phase as the per-token path would
            first = self._host_first(tok)
            if budget <= 0 or first in stops:
                return
            yield first
            i = 1
            g0 = trigger_walk(grammar, scanner, first)
            if g0 is not None:
                gstate = g0
                if gstate < 0:
                    METRICS.incr("engine.grammar_trigger_suffix_rejected")
            if gstate < 0:
                if i >= budget:
                    return
                dec = ChunkDecoder(
                    self, gen, cache, tok, key,
                    fed=len(prompt_ids), chunk=free_chunk, want=budget - 1,
                    stops=stops,
                )
                hit = False
                for ch in dec.chunks():
                    for j, t in enumerate(ch.tokens):
                        if t in stops:
                            return
                        yield t
                        i += 1
                        g = trigger_walk(grammar, scanner, t)
                        if g is not None:
                            if g >= 0:
                                gstate = g
                                cache, token, key = dec.rollback(ch, j)
                                hit = True
                                break  # enter the constrained phase
                            METRICS.incr("engine.grammar_trigger_suffix_rejected")
                        if i >= budget:
                            return
                    if hit:
                        break
                if not hit:
                    return
        else:
            # free phase, per token (gen.chunk = 1): the in-tree oracle of
            # the fused path
            tok_host = self._host_first(tok)
            while i < budget:
                if tok_host in stops:
                    return
                yield tok_host
                i += 1
                g = trigger_walk(grammar, scanner, tok_host)
                if g is not None:
                    gstate = g
                    if gstate >= 0:
                        break  # enter the constrained phase
                    METRICS.incr("engine.grammar_trigger_suffix_rejected")
                if i >= budget:
                    return
                t0 = time.time()
                with METRICS.span("decode_step"):
                    METRICS.incr("engine.decode_dispatches")
                    tok, cache, key = self._step(gen, cache, tok.reshape(1, 1), key)
                    t_issue = time.time()
                    tok_host = int(tok[0])
                FLIGHT.dispatch("dispatch.decode", t0, t_issue, time.time(),
                                mesh=self.mesh_tag, n_steps=1, slots=1)
            token = tok.reshape(1, 1)
        if gstate < 0 or i >= budget:
            return
        if gstate == grammar.accept:
            # the trigger token carried the whole call
            yield from close_ids
            return
        # constrained phase: the fused DFA decode on the live cache
        if int(grammar.min_dist[gstate]) > budget - i:
            METRICS.incr("engine.grammar_budget_too_small")
            return  # no valid call fits: truncate like any budget
        table, min_dist = grammar.device_tables(self.cfg.vocab_size, self.device,
                                                observer=self._compiles)
        gstate_dev = torch.tensor([gstate], dtype=torch.int32, device=self.device)
        remaining = torch.tensor(budget - i, dtype=torch.int32, device=self.device)
        stop_ids = set(self.tokenizer.stop_token_ids)
        s = gstate
        while i < budget:
            # clamp the chunk to the budget, which already keeps every KV
            # write inside the cache
            n = min(chunk, budget - i)
            fused = self._grammar_fused_fn(gen, n)
            with METRICS.span("grammar_fused_chunk"):
                METRICS.incr("engine.decode_dispatches")
                toks, cache, token, key, gstate_dev, remaining = fused(
                    self.params, cache, token, key, gstate_dev, remaining,
                    table, min_dist,
                )
                host = toks[0].tolist()  # the chunk's one host sync
            METRICS.incr("engine.grammar_fused_steps", len(host))
            for t in host:
                if i >= budget:
                    return
                s = int(grammar.table[s, t]) if s >= 0 else -1
                if s == grammar.accept:
                    # a stop token's accept edge ends the call without being
                    # part of its text; the closing '}' is
                    if t not in stop_ids:
                        yield t
                    yield from close_ids
                    return
                if s < 0:
                    METRICS.incr("engine.grammar_walked_off")
                    return  # unreachable under the in-chunk mask
                yield t
                i += 1
            # the chunk ended mid-grammar: token, gstate and remaining carry

    def _collect(self, stream: Iterator[int], prompt_len: int) -> GenerationResult:
        t0 = time.perf_counter()
        ttft = None
        out: list[int] = []
        for tok in stream:
            if ttft is None:
                ttft = time.perf_counter() - t0
            out.append(tok)
        total = time.perf_counter() - t0
        return self._make_result(out, prompt_len, ttft or 0.0, total)

    def generate(
        self, prompt_ids: Sequence[int], gen: GenerationConfig | None = None, **kw
    ) -> GenerationResult:
        gen = gen or GenerationConfig()
        return self._collect(self.generate_stream(prompt_ids, gen, **kw), len(prompt_ids))

    @staticmethod
    def _find_draft(
        ids: list[int], ngram: int, draft_len: int, window: int = 2048
    ) -> list[int] | None:
        """Prompt-lookup draft: the newest earlier occurrence of the last
        ``ngram`` tokens (within ``window`` positions) proposes the tokens
        that followed it."""
        if len(ids) <= ngram:
            return None
        arr = np.asarray(ids[-window:], dtype=np.int32)
        tail = arr[-ngram:]
        if arr.size <= ngram:
            return None
        wins = np.lib.stride_tricks.sliding_window_view(arr[:-1], ngram)
        hits = np.nonzero((wins == tail).all(axis=1))[0]
        # the final window (ending at the tail itself) is not a repeat
        hits = hits[hits < arr.size - ngram]
        if hits.size == 0:
            return None
        j = int(hits[-1])  # the newest repeat predicts best in agent loops
        draft = arr[j + ngram : j + ngram + draft_len].tolist()
        return draft or None

    def generate_stream_lookahead(
        self,
        prompt_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        ngram: int = 3,
        draft_len: int = 8,
    ) -> Iterator[int]:
        """Greedy streaming decode with prompt-lookup speculation: when the
        last ``ngram`` tokens repeat earlier context, the tokens that
        followed are verified in ONE forward of ``T = 1 + draft_len`` tokens
        and accepted while they equal the model's own argmax, so the stream
        is greedy ``generate_stream``'s. The verify writes T K/V rows;
        the cache's length is cut to the accepted ones and later writes
        overwrite the rest. No draft, or no room for a block: one plain
        step. Sampled configs and paged engines take the normal stream."""
        gen = gen or GenerationConfig()
        if gen.temperature != 0.0 or self.paged:
            yield from self.generate_stream(prompt_ids, gen)
            return
        stops = self._stops(gen)
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        tok, cache, key = self._prefill_sample(prompt_ids, gen)
        emitted_n = 0
        last = self._host_first(tok)
        all_ids = list(prompt_ids)
        T = 1 + draft_len
        while emitted_n < budget and last not in stops:
            yield last
            emitted_n += 1
            all_ids.append(last)
            if emitted_n >= budget:
                break
            pos = len(all_ids)  # tokens whose K/V the cache must hold next
            draft = self._find_draft(all_ids, ngram, draft_len)
            if draft is None or pos + T > self.max_seq_len:
                with METRICS.span("decode_step"):
                    tok, cache, key = self._step(
                        gen, cache, torch.tensor([[last]], device=self.device), key)
                    last = int(tok[0])
                continue
            draft = draft + [0] * (draft_len - len(draft))  # a static T
            toks = torch.tensor([[last] + draft], dtype=torch.long, device=self.device)
            with METRICS.span("spec_step"):
                logits, cache = forward(self.params, self.cfg, toks, cache,
                                        **self._fwd_kw())
                greedy = torch.argmax(logits[0], dim=-1).tolist()
            # greedy[i] is the model's token after toks[:i + 1]: accept the
            # draft while it matches the model's own argmax
            accept = 0
            while accept < draft_len and draft[accept] == greedy[accept]:
                accept += 1
            block = greedy[: accept + 1]
            # T rows were written, 1 + accept are real: the length masks
            # the rest and later writes overwrite them
            cache = cache._replace(length=torch.full(
                (1,), pos + accept, dtype=torch.int32, device=self.device))
            for t in block[:-1]:
                if emitted_n >= budget or t in stops:
                    last = t
                    break
                yield t
                emitted_n += 1
                all_ids.append(t)
            else:
                last = block[-1]
                continue
            break  # a stop or the budget inside the block

    def generate_lookahead(
        self,
        prompt_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        ngram: int = 3,
        draft_len: int = 8,
    ) -> GenerationResult:
        """Collected form of ``generate_stream_lookahead`` with timings."""
        gen = gen or GenerationConfig()
        return self._collect(
            self.generate_stream_lookahead(prompt_ids, gen, ngram=ngram,
                                           draft_len=draft_len),
            len(prompt_ids))

    def generate_fused(
        self,
        prompt_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        chunk: int = 64,
    ) -> GenerationResult:
        """Chunked high-throughput generation: one host sync per ``chunk``
        decoded tokens, the fused scan the streaming path uses. A paged
        engine decodes through the scheduler (its multi-step scan)."""
        gen = gen or GenerationConfig()
        if self.paged:
            return self.generate(prompt_ids, gen)
        return self._collect(
            self._stream_chunked(prompt_ids, gen, max(1, chunk)), len(prompt_ids)
        )

    def chat(self, messages: list[dict], gen: GenerationConfig | None = None) -> GenerationResult:
        """One chat turn. A greedy turn on a dense engine speculates with
        prompt lookup (chat turns echo the conversation), giving greedy's
        tokens."""
        ids = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        gen = gen or GenerationConfig()
        if gen.temperature == 0.0 and not self.paged:
            return self.generate_lookahead(ids, gen)
        return self.generate(ids, gen)
