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
  before chunk k's tokens are read back, so the host's stop scan overlaps
  the device's work.

The grammar trigger rollback (``ChunkDecoder.rollback``, ``trigger_walk``)
and kernel looping come with the tool-grammar module (roadmap A6).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from fei_tpu_torch.engine.sampling import sample_logits, stop_mask
from fei_tpu_torch.utils.metrics import METRICS

DEFAULT_CHUNK = 16


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


def build_fused_decode(fwd: Callable, cfg, gen, n_steps: int) -> Callable:
    """The N-step free-decode function for one sampling config.

    Returns ``fused(params, cache, token, generator, done, stop_ids)`` →
    ``(toks [B, n], cache, token [B, 1], done [B])``. ``stop_ids`` is an
    int32 [S] device tensor (S may be 0). The cache's K/V are updated in
    place."""
    temperature, top_k, top_p, min_p = (
        gen.temperature, gen.top_k, gen.top_p, gen.min_p
    )

    def fused(params, cache, token, generator, done, stop_ids):
        toks = []
        for _ in range(n_steps):
            live = ~done
            logits, cache = fwd(params, cfg, token, cache, live=live)
            nxt = sample_logits(
                logits[:, -1, :], generator,
                temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            )
            # a dead step recycles the carry token: nothing new is sampled
            nxt = torch.where(live, nxt, token[:, 0])
            done = done | stop_mask(nxt, stop_ids)
            token = nxt[:, None]
            toks.append(nxt)
        return torch.stack(toks, dim=1), cache, token, done

    return fused


@dataclass
class DecodedChunk:
    """One host-synced chunk. ``tokens[j]`` was sampled at step j; ``fed0``
    is the cache length (tokens consumed) before the chunk's first step."""

    tokens: list[int]
    fed0: int


class ChunkDecoder:
    """Software-pipelined chunked free decode over a live dense cache.

    ``chunks()`` yields ``DecodedChunk``s; the dispatch of chunk k+1 always
    precedes the blocking host read of chunk k. Full chunks are dispatched
    while the cache has room (the host truncates at the budget); the last
    one is clamped so no KV slot past ``max_seq_len`` is written.
    """

    def __init__(
        self, engine, gen, cache, token, generator, *,
        fed: int, chunk: int, want: int, stops=(),
    ):
        self._engine = engine
        self._gen = gen
        self._cache = cache
        self._token = token.reshape(token.shape[0], 1)
        self._generator = generator
        device = self._token.device
        self._done = torch.zeros((self._token.shape[0],), dtype=torch.bool, device=device)
        self._stop_ids = torch.tensor(sorted(stops), dtype=torch.int32, device=device)
        self._fed = fed
        self._chunk = max(1, int(chunk))
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
                t0 = time.perf_counter()
                toks, self._cache, self._token, self._done = fused(
                    self._engine.params, self._cache, self._token,
                    self._generator, self._done, self._stop_ids,
                )
                METRICS.timing("dispatch_issue", time.perf_counter() - t0)
                nxt = (toks, self._fed)
                self._fed += n
                self._slots_left -= n
                self._sched += n
            if pending is not None:
                toks_p, fed0_p = pending
                with METRICS.span("decode_chunk"):
                    # the one blocking point: chunk k+1 is already issued
                    host = toks_p[0].tolist()
                yield DecodedChunk(tokens=host, fed0=fed0_p)
            elif nxt is None:
                return
            pending = nxt
