"""The dense inference engine: bucketed prefill + streaming decode
(counterpart of the dense half of fei_tpu/engine/engine.py).

- **Prefill** pads the prompt to a power-of-two bucket and runs one
  forward; on the card, prompt-sized T goes through the flash-attention
  kernel (models/llama.py ``_attend``).
- **Decode** is fused-chunked by default (engine/fused_decode.py): one host
  sync per ``chunk`` tokens with an on-device stop. ``chunk=1`` keeps the
  per-token loop, the in-tree parity oracle.
- **Sampling** runs on the device; only sampled ids cross to the host. Each
  request draws from its own ``torch.Generator`` seeded with
  ``GenerationConfig.seed``.
- **Static shapes**: the cache is a fixed [L, B, S, K, D] buffer with a
  valid length per sequence; prompt padding is never attended and is
  overwritten slot by slot during decode.

- **Paged** (``paged=True``): a shared page pool with continuous batching
  (engine/scheduler.py ``PagedScheduler``); every generation call goes
  through the scheduler, and concurrent callers share one batched decode.

- **Weight-only int8 / int4** (``quantize``): the big linears are
  quantized at init or while a checkpoint is read (``ops.quant``); int4
  products run the K4 kernel, dense and paged alike.

- **Constrained tool calls** (``generate_constrained``,
  ``generate_stream_toolcalls``): the grammar's DFA steps on the device
  inside each decode chunk (``_grammar_fused_fn``: the state's table row,
  the budget-feasibility mask, the sample, the next state), so a
  constrained chunk syncs with the host once, like a free one. A free
  phase that finds the ``<tool_call>`` trigger mid-chunk rolls the cache
  and the generator back to that token (``ChunkDecoder.rollback``).

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu") and
raises ``EngineError`` when CUDA is asked for and missing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import torch

from fei_tpu_torch.engine.fused_decode import (
    ChunkDecoder,
    build_fused_decode,
    resolve_chunk,
    trigger_walk,
)
from fei_tpu_torch.engine.sampling import sample_logits
from fei_tpu_torch.engine.tokenizer import load_tokenizer
from fei_tpu_torch.models.configs import ModelConfig, get_model_config
from fei_tpu_torch.models.llama import (
    QUANT_MODES,
    KVCache,
    _logits,
    check_supported,
    forward,
    init_params,
)
from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.metrics import METRICS


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
    ):
        self.cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len or model_cfg.max_seq_len
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = resolve_device(device)
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
        self._scheduler = None
        if paged:
            from fei_tpu_torch.engine.scheduler import PagedScheduler

            self._scheduler = PagedScheduler(self)

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
        int4_lm_head: bool = False,
        quant_embed: bool = False,
        **overrides,
    ) -> "InferenceEngine":
        """Random-init (from ``seed``, on ``device``) or checkpoint weights;
        ``params`` hands over an existing parameter dict instead (engines
        sharing weights). ``quantize`` ("int8" or "int4") quantizes the big
        linears as they are made or read; ``int4_lm_head`` puts the LM head
        in int4 too and ``quant_embed`` row-quantizes the embedding table."""
        if quantize not in QUANT_MODES:
            raise EngineError(
                f"unsupported quantize mode {quantize!r}; one of "
                f"{[m for m in QUANT_MODES if m]} (or unset)"
            )
        qkw = dict(quantize=quantize, int4_lm_head=int4_lm_head, quant_embed=quant_embed)
        dev = resolve_device(device)
        cfg = get_model_config(name, **overrides)
        tok = load_tokenizer(tokenizer)
        if params is not None:
            check_supported(cfg)
        elif checkpoint_dir:
            from fei_tpu_torch.engine.weights import load_checkpoint

            cfg, params = load_checkpoint(checkpoint_dir, cfg, dtype=dtype, device=dev,
                                          **qkw)
        else:
            params = init_params(cfg, seed=seed, dtype=dtype, device=dev, **qkw)
        return cls(
            cfg, params, tok, max_seq_len=max_seq_len, batch_size=batch_size,
            dtype=dtype, device=dev, paged=paged, page_size=page_size,
            num_pages=num_pages, kv_quant=kv_quant, prefix_cache=prefix_cache,
        )

    # -- paged pool ---------------------------------------------------------

    def _ensure_pool(self):
        """Lazily create the shared page pool + allocator (paged mode). The
        default pool holds ``batch_size`` full-length sequences plus the
        null page; ``num_pages`` sizes it to a memory budget instead."""
        from fei_tpu_torch.engine.paged_cache import PageAllocator, PagedKVCache

        table_width = -(-self.max_seq_len // self.page_size)
        num_pages = self.num_pages or (self.batch_size * table_width + 1)
        if self._pool is None:
            self._pool = PagedKVCache.create(
                self.cfg, num_pages, self.batch_size, table_width,
                page_size=self.page_size, dtype=self.dtype, kv_quant=self.kv_quant,
                device=self.device,
            )
        if self._allocator is None:
            self._allocator = PageAllocator(num_pages, self.page_size)
        return self._pool

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
        """Stop the paged scheduler's loop thread (a dense engine has none)."""
        if self._scheduler is not None:
            self._scheduler.close()

    # -- device programs ----------------------------------------------------

    def _step(self, gen: GenerationConfig, cache, token, generator, logit_mask=None):
        """One decode step: forward T=1, optional mask, sample on device.
        Returns (next_token [B] int32, cache)."""
        logits, cache = forward(self.params, self.cfg, token, cache)
        logits = logits[:, -1, :]
        if logit_mask is not None:
            logits = torch.where(logit_mask, logits, float("-inf"))
        nxt = sample_logits(
            logits, generator, temperature=gen.temperature, top_k=gen.top_k,
            top_p=gen.top_p, min_p=gen.min_p,
        )
        return nxt, cache

    def _free_fused_fn(self, gen: GenerationConfig, n_steps: int) -> Callable:
        """The N-step fused free-decode function (fused_decode)."""
        return build_fused_decode(forward, self.cfg, gen, n_steps)

    def _grammar_fused_fn(self, gen: GenerationConfig, n_steps: int) -> Callable:
        """Constrained fused decode: the grammar's DFA steps on the device
        inside the chunk — row = table[state], the budget-feasibility mask
        on the logits, the sample, state' = row[token] — so a constrained
        chunk of ``n_steps`` tokens makes no host sync of its own.

        Returns ``fused(params, cache, token, generator, gstate, remaining,
        table, min_dist)`` → ``(toks [B, n], cache, token [B, 1], gstate,
        remaining)``; ``gstate`` is int32 [B], ``remaining`` an int32
        tensor, ``table`` int16/int32 [S, V] and ``min_dist`` int32 [S],
        all on the engine's device."""
        from fei_tpu_torch.engine.grammar import grammar_step

        temperature, top_k, top_p, min_p = (
            gen.temperature, gen.top_k, gen.top_p, gen.min_p
        )
        cfg = self.cfg

        def fused(params, cache, token, generator, gstate, remaining, table, min_dist):
            toks = []
            for _ in range(n_steps):
                logits, cache = forward(params, cfg, token, cache)
                logits, advance = grammar_step(
                    logits[:, -1, :], table, min_dist, gstate, remaining)
                nxt = sample_logits(
                    logits, generator, temperature=temperature, top_k=top_k,
                    top_p=top_p, min_p=min_p,
                )
                gstate, remaining = advance(nxt)
                token = nxt[:, None]
                toks.append(nxt)
            return torch.stack(toks, dim=1), cache, token, gstate, remaining

        return fused

    # -- generation ---------------------------------------------------------

    def new_cache(self, batch: int | None = None) -> KVCache:
        return KVCache.create(
            self.cfg, batch or self.batch_size, self.max_seq_len,
            dtype=self.dtype, device=self.device,
        )

    def _pad_mask(self, mask) -> torch.Tensor | None:
        mask = pad_vocab_mask(mask, self.cfg.vocab_size)
        return None if mask is None else mask.to(self.device)

    def _stops(self, gen: GenerationConfig) -> set[int]:
        if gen.ignore_eos:
            return set()
        return set(gen.stop_token_ids) | set(self.tokenizer.stop_token_ids)

    def prefill(
        self, prompt_ids: Sequence[Sequence[int]], cache: KVCache,
        flash: bool | None = None,
    ):
        """Pad prompts to a bucket, run one forward, fix cache lengths.
        Returns (last_valid_logits [B, V] float32, cache). Only the last
        valid position goes through the LM head. ``flash`` picks the
        attention path (None: the kernel for prompt-sized T on the card)."""
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
        hidden, cache = forward(
            self.params, self.cfg, padded, cache, lm_head=False, flash=flash
        )
        # padding wrote garbage kv beyond each true length; resetting the
        # length masks it out of attention and decode overwrites it
        cache = cache._replace(length=true_len)
        last = hidden[torch.arange(B, device=self.device), true_len.long() - 1]
        return _logits(last, self.params, self.cfg), cache

    def _prefill_sample(self, prompt_ids, gen: GenerationConfig, mask=None):
        """Shared prologue: prefill, optional first-token logit mask,
        sample. Returns (tok [1] int32, cache, generator)."""
        with METRICS.span("prefill"):
            last_logits, cache = self.prefill([list(prompt_ids)], self.new_cache(1))
            if mask is not None:
                last_logits = torch.where(mask[None, :], last_logits, float("-inf"))
            # the request's own sampling stream, on the engine's device
            generator = torch.Generator(device=self.device).manual_seed(int(gen.seed))
            tok = sample_logits(
                last_logits, generator, temperature=gen.temperature,
                top_k=gen.top_k, top_p=gen.top_p, min_p=gen.min_p,
            )
        return tok, cache, generator

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
    ) -> Iterator[int]:
        """Stream sampled token ids for a single prompt (batch=1).

        ``logit_mask_fn`` maps the tokens generated so far to a bool [V]
        mask of allowed next tokens (or None); it forces the per-token
        loop, since the mask needs every token on the host. Unmasked
        decoding is fused-chunked (``gen.chunk``; 1 = per-token loop)."""
        gen = gen or GenerationConfig()
        if self.paged:
            # continuous batching: the scheduler admits this request into a
            # batch slot; concurrent streams share the pool and the steps
            yield from self.scheduler.stream(prompt_ids, gen, logit_mask_fn)
            return
        if logit_mask_fn is None and resolve_chunk(gen.chunk) > 1:
            yield from self._stream_chunked(prompt_ids, gen, resolve_chunk(gen.chunk))
            return
        stops = self._stops(gen)
        generated: list[int] = []
        mask = self._pad_mask(logit_mask_fn(generated)) if logit_mask_fn else None
        # never decode past the cache: each step writes one KV slot
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        tok, cache, generator = self._prefill_sample(prompt_ids, gen, mask)
        tok_host = int(tok[0])
        for i in range(budget):
            if tok_host in stops:
                break
            generated.append(tok_host)
            yield tok_host
            if i == budget - 1:
                break  # cache full: no step whose KV slot does not exist
            mask = self._pad_mask(logit_mask_fn(generated)) if logit_mask_fn else None
            with METRICS.span("decode_step"):
                METRICS.incr("engine.decode_dispatches")
                tok, cache = self._step(
                    gen, cache, tok.reshape(1, 1), generator,
                    None if mask is None else mask[None, :],
                )
                tok_host = int(tok[0])  # host sync inside the span

    def _stream_chunked(
        self, prompt_ids: Sequence[int], gen: GenerationConfig, chunk: int
    ) -> Iterator[int]:
        """Fused chunked free decode: software-pipelined ChunkDecoder
        dispatches, host truncation at stops and budget."""
        stops = self._stops(gen)
        budget = min(gen.max_new_tokens, self.max_seq_len - len(prompt_ids))
        tok, cache, generator = self._prefill_sample(prompt_ids, gen)
        first = int(tok[0])
        if budget <= 0 or first in stops:
            return
        yield first
        if budget == 1:
            return
        dec = ChunkDecoder(
            self, gen, cache, tok, generator,
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
        table, min_dist = grammar.device_tables(self.cfg.vocab_size, self.device)
        # first token: the prefill logits masked by the entry row, with the
        # budget-feasibility rule the device steps apply
        entry_mask = self._pad_mask(
            feasible_mask(grammar.table[grammar.entry], grammar.min_dist, budget))
        tok, cache, generator = self._prefill_sample(prompt_ids, gen, entry_mask)
        slots_left = self.max_seq_len - len(prompt_ids) - 1
        first = int(tok[0])
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
                    toks, cache, token, gstate, remaining = fused(
                        self.params, cache, token, generator, gstate, remaining,
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
        tok, cache, generator = self._prefill_sample(prompt_ids, gen)
        gstate = -1
        i = 0
        token = tok.reshape(1, 1)
        free_chunk = resolve_chunk(gen.chunk)
        if free_chunk > 1:
            # free phase, fused-chunked: the host TriggerScanner reads each
            # chunk while the next one computes; a mid-chunk trigger rolls
            # the cache and generator back to the exact token and enters
            # the constrained phase as the per-token path would
            first = int(tok[0])
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
                    self, gen, cache, tok, generator,
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
                                cache, token, generator = dec.rollback(ch, j)
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
            tok_host = int(tok[0])
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
                with METRICS.span("decode_step"):
                    METRICS.incr("engine.decode_dispatches")
                    tok, cache = self._step(gen, cache, tok.reshape(1, 1), generator)
                    tok_host = int(tok[0])
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
        table, min_dist = grammar.device_tables(self.cfg.vocab_size, self.device)
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
                toks, cache, token, gstate_dev, remaining = fused(
                    self.params, cache, token, generator, gstate_dev, remaining,
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
        """One chat turn. (The JAX engine's greedy turns speculate with
        prompt lookup, token-identical to plain greedy; speculation is
        roadmap module C3, so greedy turns here decode plainly.)"""
        ids = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        return self.generate(ids, gen or GenerationConfig())
