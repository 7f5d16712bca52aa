"""Fused chunked free-phase decode: one host sync per N tokens
(counterpart of fei_tpu/engine/fused_decode.py).

- ``build_fused_decode`` returns a function that decodes N steps with no
  host sync inside them: each step runs the forward, samples on the
  device and latches a device-side ``done`` flag when a stop id is
  sampled. Once ``done`` is set, later steps are no-ops on the state: the
  KV slots keep their contents, ``cache.length`` does not advance and the
  carry token repeats (the contract of the JAX scan's dead branch). The
  JAX scan skips a dead step's compute under ``lax.cond``; here, where a
  skip would need the host to read ``done``, the step computes and its
  writes are masked, so the cost of a stop is at most one chunk's tail.
- ``ChunkDecoder`` drives it software-pipelined: chunk k+1 is issued
  before chunk k's tokens are read back, so the host's stop and trigger
  scan overlaps the device's work. A consumer that finds a grammar
  trigger mid-chunk calls ``rollback``: the cache length goes back to the
  exact token (the chunk tail and the chunk in flight are garbage above
  it, never attended) and the threefry key to its value after that
  token's draw, a row of the ``[n, 2]`` per-step keys the chunk wrote on
  the device (the reference keeps each step's key the same way).
- ``trigger_walk`` is the one host trigger-watch step that every free
  phase shares (the dense ``generate_stream_toolcalls`` and the paged
  scheduler's ``_grammar_advance``).

- ``resolve_kernel_loop`` reads the reference's kernel-looping factor
  (``FEI_TPU_KERNEL_LOOP``, default 1): ``ChunkDecoder`` dispatches
  ``chunk × factor`` steps at a time and sets the
  ``engine.kernel_loop_depth`` gauge to steps × layers. The tokens do not
  change (a stop still latches ``done`` on the device and the host
  truncates at stops and the budget). The JAX package compiles the longer
  chunk into one program; in this eager port each step still launches its
  own kernels, so the factor saves host syncs (one per dispatched chunk),
  not launches.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from fei_tpu_torch.engine import prng
from fei_tpu_torch.engine.sampling import sample_logits, stop_mask
from fei_tpu_torch.obs import costmodel
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.utils.metrics import METRICS

DEFAULT_CHUNK = 16


def trigger_walk(grammar, scanner, token_id: int) -> int | None:
    """Feed one sampled token to the ``TriggerScanner``; None while no new
    trigger occurrence has completed, otherwise the DFA state reached by
    char-walking the post-trigger suffix: ``grammar.accept`` when the
    token carried a whole call, ``>= 0`` to enter constrained decode
    there, ``< 0`` when the DFA rejects the suffix (callers count the
    rejection and stay free)."""
    from fei_tpu_torch.engine.grammar import char_walk

    suffix = scanner.feed(token_id)
    if suffix is None:
        return None
    return char_walk(grammar, suffix)


def resolve_chunk(gen_chunk: int = 0) -> int:
    """Effective free-phase decode chunk: ``GenerationConfig.chunk`` when
    positive, else ``FEI_TPU_DECODE_CHUNK`` (default 16). ``1`` selects the
    per-token reference path."""
    if gen_chunk and gen_chunk > 0:
        return int(gen_chunk)
    try:
        return max(1, int(os.environ.get("FEI_TPU_DECODE_CHUNK", str(DEFAULT_CHUNK))))
    except ValueError:
        return DEFAULT_CHUNK


def resolve_kernel_loop() -> int:
    """Kernel-looping factor of the fused free-phase chunk
    (``FEI_TPU_KERNEL_LOOP``, default 1 = off; 0, a negative number or
    anything that is not an integer reads as 1). A factor of L makes each
    dispatched chunk ``chunk × L`` steps long: L× fewer host syncs, at
    the cost of up to L× the steps computed past a stop."""
    try:
        return max(1, int(os.environ.get("FEI_TPU_KERNEL_LOOP", "1")))
    except ValueError:
        return 1


def build_fused_decode(fwd: Callable, cfg, gen, n_steps: int) -> Callable:
    """The N-step free-decode function for one sampling config.

    Returns ``fused(params, cache, token, key, done, stop_ids)`` →
    ``(toks [B, n], cache, token [B, 1], key, done [B], keys [n, 2])``.
    ``key`` is the request's threefry key ([2], on the device): a sampled
    step splits it once and draws with the second half, as the
    reference's ``rng, sub = split(rng)``; ``keys[j]`` is the key after
    step j, so a consumer can re-enter decoding from an exact mid-chunk
    state. A dead step (after the stop) splits nothing; a greedy config
    splits nothing and returns ``keys`` None.
    ``stop_ids`` is an int32 [S] device tensor (S may be 0). The cache's
    K/V are updated in place."""
    temperature, top_k, top_p, min_p = (
        gen.temperature, gen.top_k, gen.top_p, gen.min_p
    )
    sampled = temperature > 0.0

    def fused(params, cache, token, key, done, stop_ids):
        toks, keys = [], []
        for _ in range(n_steps):
            live = ~done
            logits, cache = fwd(params, cfg, token, cache, live=live)
            sub = None
            if sampled:
                nk, sub = prng.split(key)
                key = torch.where(live, nk, key)
            nxt = sample_logits(
                logits[:, -1, :], sub,
                temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            )
            # a dead step recycles the carry token: nothing new is sampled
            nxt = torch.where(live, nxt, token[:, 0])
            done = done | stop_mask(nxt, stop_ids)
            token = nxt[:, None]
            toks.append(nxt)
            keys.append(key)
        return (torch.stack(toks, dim=1), cache, token, key, done,
                torch.stack(keys) if sampled else None)

    return fused


@dataclass
class DecodedChunk:
    """One host-synced chunk. ``tokens[j]`` was sampled at step j;
    ``keys[j]`` is the key after step j (an [n, 2] device tensor; None
    for greedy, whose key never moves);
    ``fed0`` is the cache length (tokens consumed) before the chunk's
    first step."""

    tokens: list[int]
    keys: torch.Tensor
    fed0: int


class ChunkDecoder:
    """Software-pipelined chunked free decode over a live dense cache.

    ``chunks()`` yields ``DecodedChunk``s; the dispatch of chunk k+1 always
    precedes the blocking host read of chunk k. Full chunks are dispatched
    while the cache has room (the host truncates at the budget); the last
    one is clamped so no KV slot past ``max_seq_len`` is written.
    Abandoning the iterator abandons the chunk in flight; ``rollback``
    returns the exact mid-chunk state to resume from.
    """

    def __init__(
        self, engine, gen, cache, token, key, *,
        fed: int, chunk: int, want: int, stops=(),
    ):
        self._engine = engine
        self._gen = gen
        self._cache = cache
        self._token = token.reshape(token.shape[0], 1)
        self._key = key
        device = self._token.device
        self._done = torch.zeros((self._token.shape[0],), dtype=torch.bool, device=device)
        self._stop_ids = torch.tensor(sorted(stops), dtype=torch.int32, device=device)
        self._fed = fed
        # kernel looping: each dispatch runs chunk × factor steps; its
        # tokens are read back once, as one chunk
        self._chunk = max(1, int(chunk)) * resolve_kernel_loop()
        self._want = want
        self._sched = 0
        self._slots_left = engine.max_seq_len - fed - 1

    def chunks(self) -> Iterator[DecodedChunk]:
        pending: tuple | None = None
        while True:
            nxt: tuple | None = None
            if self._sched < self._want and self._slots_left > 0:
                n = min(self._chunk, self._slots_left)
                fused = self._engine._free_fused_fn(self._gen, n)
                METRICS.incr("engine.decode_dispatches")
                METRICS.gauge("engine.kernel_loop_depth", n * self._engine.cfg.num_layers)
                t0 = time.time()
                toks, self._cache, self._token, self._key, self._done, keys = fused(
                    self._engine.params, self._cache, self._token,
                    self._key, self._done, self._stop_ids,
                )
                t_issue = time.time()
                METRICS.timing("dispatch_issue", t_issue - t0)
                # the sync is pipelined: chunk k is read in the NEXT
                # iteration's decode_chunk span, so this record carries no
                # sync time (the reference records its chunks the same way)
                FLIGHT.dispatch(
                    "dispatch.decode", t0, t_issue, t_issue,
                    mesh=self._engine.mesh_tag, n_steps=n,
                    slots=int(self._token.shape[0]), pipelined=True,
                )
                nxt = (toks, keys, self._fed, t0, n)
                self._fed += n
                self._slots_left -= n
                self._sched += n
            if pending is not None:
                toks_p, keys_p, fed0_p, t0_p, n_p = pending
                with METRICS.span("decode_chunk"):
                    # the one blocking point: chunk k+1 is already issued
                    host = toks_p[0].tolist()
                slots = int(self._token.shape[0])
                costmodel.account_dispatch(self._engine, n_p, fed0_p * slots, slots,
                                           time.time() - t0_p)
                yield DecodedChunk(tokens=host, keys=keys_p, fed0=fed0_p)
            elif nxt is None:
                return
            pending = nxt

    def rollback(self, ch: DecodedChunk, j: int):
        """State as if decoding had stopped right after ``ch.tokens[j]``:
        ``(cache, token [1, 1], key)``. The cache length is set back
        explicitly to the tokens actually consumed (``fed0 + j + 1``:
        ``tokens[j]`` itself has not been fed); the K/V written above it
        by the chunk's tail and by the chunk in flight are never attended
        and are overwritten slot by slot by whoever resumes. The key is
        the chunk's key after step j, read on the device."""
        fed = ch.fed0 + j + 1
        cache = self._cache._replace(length=torch.full_like(self._cache.length, fed))
        token = torch.tensor([[ch.tokens[j]]], dtype=torch.int32,
                             device=self._token.device)
        return cache, token, self._key if ch.keys is None else ch.keys[j]
