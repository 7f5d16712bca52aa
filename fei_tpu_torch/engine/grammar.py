"""Grammar-constrained decoding: JSON schema → character DFA → token masks
(a copy of fei_tpu/engine/grammar.py; the tables are built in numpy, so
both packages build bitwise the same ones).

The agent's tool calls must be valid JSON matching each tool's input schema:
the local decoder *cannot emit* an invalid call. Pipeline:

  schema ──compile──▶ char-level DFA (states × 256 bytes)
         ──lift────▶ token-level transition table (states × vocab)
         ──decode──▶ per-step boolean logit mask for the engine's
                      ``logit_mask_fn`` hook (engine.py generate_stream)

Schema subset (what tool-call arguments actually use — tools/definitions.py):
object with ordered properties, string, integer, number, boolean, null,
enum of strings, arrays of any supported type, nested objects. Objects are
emitted compact (no whitespace) with properties in schema order.

The token table is a dense [n_states, vocab] array (-1 = forbidden; int16
when the state count fits), so each decode step is two O(1) lookups. As
torch tensors on the engine's device (``TokenGrammar.device_tables``) the
same tables drive a fully on-device constrained decode (mask = table[state]
>= 0, state' = table[state, token]) with no per-token host round-trip;
``feasible_mask`` takes numpy arrays (host masks) and torch tensors
(inside the decode chunk) alike, and ``grammar_step`` is the one on-device
DFA step that the dense chunk and the paged scheduler both run.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from fei_tpu_torch.utils.errors import EngineError

_ESCAPES = b'"\\/bfnrt'
_DIGITS = b"0123456789"
_SERIALS = itertools.count()  # the compile observer's grammar identities


class _DFA:
    """Mutable char-level DFA under construction.

    Each state is a dict byte→state. ``also[s]`` marks a lower-precedence
    fallback state whose transitions apply where s has none (used for value
    states like numbers that terminate on whatever char *follows* them).
    ``default[s]`` catches all bytes not in the dict (string bodies).
    """

    def __init__(self):
        self.trans: list[dict[int, int]] = []
        self.also: list[int | None] = []
        self.default: list[int | None] = []

    def new_state(self) -> int:
        self.trans.append({})
        self.also.append(None)
        self.default.append(None)
        return len(self.trans) - 1

    def lit(self, text: bytes, nxt: int) -> int:
        """Chain of literal bytes ending at ``nxt`` (built backwards)."""
        for b in reversed(text):
            s = self.new_state()
            self.trans[s][b] = nxt
            nxt = s
        return nxt

    def char_table(self) -> np.ndarray:
        """Resolve also/default into a dense [n_states, 256] int32 table."""
        n = len(self.trans)
        table = np.full((n, 256), -1, dtype=np.int32)
        for s in range(n):
            if self.default[s] is not None:
                table[s, :] = self.default[s]
                # control chars are never legal raw in JSON strings
                table[s, :0x20] = -1
            # walk the also-chain lowest precedence first
            chain = []
            cur = self.also[s]
            while cur is not None:
                chain.append(cur)
                cur = self.also[cur]
            for fb in reversed(chain):
                for b, t in self.trans[fb].items():
                    table[s, b] = t
            for b, t in self.trans[s].items():
                table[s, b] = t
        return table


class JsonSchemaGrammar:
    """Compile a JSON schema into a char DFA with entry/accept states."""

    def __init__(self, schema: dict):
        self.schema = schema
        self.dfa = _DFA()
        self.accept = self.dfa.new_state()  # state 0: generation complete
        self.entry = self._value(schema, self.accept)
        self.char_table = self.dfa.char_table()

    # each _X(schema, nxt) returns the entry state, built back-to-front

    def _value(self, schema: dict, nxt: int) -> int:
        if "enum" in schema:
            return self._enum(schema["enum"], nxt)
        t = schema.get("type", "object")
        if isinstance(t, list):  # e.g. ["string", "null"]
            return self._union([{**schema, "type": ti} for ti in t], nxt)
        builder = {
            "object": self._object,
            "string": self._string,
            "integer": self._number,
            "number": self._number,
            "boolean": self._boolean,
            "null": self._null,
            "array": self._array,
        }.get(t)
        if builder is None:
            raise EngineError(f"unsupported schema type: {t!r}")
        if t == "integer":
            return self._number({**schema, "_integer": True}, nxt)
        return builder(schema, nxt)

    def _union(self, schemas: list[dict], nxt: int) -> int:
        entry = self.dfa.new_state()
        for sub in schemas:
            e = self._value(sub, nxt)
            for b, t in self.dfa.trans[e].items():
                self.dfa.trans[entry].setdefault(b, t)
            if self.dfa.default[e] is not None and self.dfa.default[entry] is None:
                self.dfa.default[entry] = self.dfa.default[e]
        return entry

    def _object(self, schema: dict, nxt: int) -> int:
        """Object with properties in schema order; properties listed in the
        schema's ``required`` are mandatory, the rest may be skipped (the
        reference's registry validates only ``required``,
        fei/tools/registry.py:92-153). A schema with NO ``required`` key
        keeps the all-properties-mandatory behavior — for *generation* that
        is the deterministic safe reading of an unannotated schema."""
        props: dict = schema.get("properties", {})
        if not props:
            return self.dfa.lit(b"{}", nxt)
        items = list(props.items())
        n = len(items)
        required = set(schema.get("required", [k for k, _ in items]))
        unknown = required - {k for k, _ in items}
        if unknown:
            raise EngineError(
                f"schema lists required properties not in 'properties': "
                f"{sorted(unknown)}"
            )
        # opt_suffix[i]: every property from i on is optional, so '}' is
        # legal from the separator state with candidates i..n-1
        opt_suffix = [False] * (n + 1)
        opt_suffix[n] = True
        for i in range(n - 1, -1, -1):
            opt_suffix[i] = opt_suffix[i + 1] and items[i][0] not in required

        def choices(start: int) -> list[tuple[bytes, int]]:
            """Emittable next properties from position ``start``: each
            optional property may be skipped, a required one may not."""
            opts = []
            j = start
            while j < n:
                key, _ = items[j]
                opts.append((b'"' + key.encode("utf-8") + b'":', value_entry[j]))
                if key in required:
                    break
                j += 1
            return opts

        # built back-to-front: sep[i] = "a value just closed; properties
        # i..n-1 remain candidates" (',' continues, '}' closes if allowed)
        sep: list[int | None] = [None] * (n + 1)
        s = self.dfa.new_state()
        self.dfa.trans[s][0x7D] = nxt  # '}'
        sep[n] = s
        value_entry: list[int | None] = [None] * n
        for i in range(n - 1, -1, -1):
            value_entry[i] = self._value(items[i][1], sep[i + 1])
            s = self.dfa.new_state()
            self.dfa.trans[s][0x2C] = self._branch(choices(i))  # ','
            if opt_suffix[i]:
                self.dfa.trans[s][0x7D] = nxt
            sep[i] = s

        first = self._branch(choices(0))
        if opt_suffix[0]:
            self.dfa.trans[first][0x7D] = nxt  # '{}' legal
        entry = self.dfa.new_state()
        entry_trans = self.dfa.trans[entry]
        entry_trans[0x7B] = first  # '{'
        return entry

    def _branch(self, options: list[tuple[bytes, int]]) -> int:
        """Trie over distinct byte strings sharing one entry state, each
        path ending at its target — the choice point for which property to
        emit next (keys can share prefixes)."""
        groups: dict[int, list[tuple[bytes, int]]] = {}
        for bs, tgt in options:
            if not bs:
                raise EngineError("ambiguous property-name trie (empty branch)")
            groups.setdefault(bs[0], []).append((bs[1:], tgt))
        entry = self.dfa.new_state()
        for b, subs in groups.items():
            if len(subs) == 1:
                rest, tgt = subs[0]
                self.dfa.trans[entry][b] = self.dfa.lit(rest, tgt)
            else:
                self.dfa.trans[entry][b] = self._branch(subs)
        return entry

    def _string(self, schema: dict, nxt: int) -> int:
        body = self.dfa.new_state()
        esc = self.dfa.new_state()
        self.dfa.default[body] = body
        self.dfa.trans[body][0x22] = nxt  # closing "
        self.dfa.trans[body][0x5C] = esc  # backslash
        for b in _ESCAPES:
            self.dfa.trans[esc][b] = body
        open_q = self.dfa.new_state()
        self.dfa.trans[open_q][0x22] = body
        return open_q

    def _number(self, schema: dict, nxt: int) -> int:
        integer_only = schema.get("_integer", False)
        # digit-loop states terminate via fallback on whatever follows
        int_loop = self.dfa.new_state()
        for b in _DIGITS:
            self.dfa.trans[int_loop][b] = int_loop
        self.dfa.also[int_loop] = nxt
        # JSON forbids leading zeros: a leading '0' may only be followed by
        # '.' (or terminate) — never another digit
        zero = self.dfa.new_state()
        self.dfa.also[zero] = nxt
        if not integer_only:
            frac_loop = self.dfa.new_state()
            for b in _DIGITS:
                self.dfa.trans[frac_loop][b] = frac_loop
            self.dfa.also[frac_loop] = nxt
            frac_first = self.dfa.new_state()
            for b in _DIGITS:
                self.dfa.trans[frac_first][b] = frac_loop
            self.dfa.trans[int_loop][0x2E] = frac_first  # '.'
            self.dfa.trans[zero][0x2E] = frac_first
        first_digit = self.dfa.new_state()  # after '-'
        for b in _DIGITS[1:]:
            self.dfa.trans[first_digit][b] = int_loop
        self.dfa.trans[first_digit][ord("0")] = zero
        entry = self.dfa.new_state()
        for b in _DIGITS[1:]:
            self.dfa.trans[entry][b] = int_loop
        self.dfa.trans[entry][ord("0")] = zero
        self.dfa.trans[entry][0x2D] = first_digit  # '-'
        return entry

    def _boolean(self, schema: dict, nxt: int) -> int:
        t = self.dfa.lit(b"rue", nxt)
        f = self.dfa.lit(b"alse", nxt)
        entry = self.dfa.new_state()
        self.dfa.trans[entry][ord("t")] = t
        self.dfa.trans[entry][ord("f")] = f
        return entry

    def _null(self, schema: dict, nxt: int) -> int:
        return self.dfa.lit(b"null", nxt)

    def _enum(self, values: list, nxt: int) -> int:
        # explicit trie over the JSON encodings, then materialize: a node
        # that ends a value AND continues a longer one keeps its child edges
        # with ``nxt`` as fallback (also), so prefix pairs like 1 / 12 both
        # stay generatable and nothing illegal (e.g. 1222) sneaks through
        import json as _json

        trie: dict = {}
        TERM = object()
        for val in values:
            node = trie
            for b in _json.dumps(val).encode("utf-8"):
                node = node.setdefault(b, {})
            node[TERM] = True

        def materialize(node: dict) -> int:
            children = {b: c for b, c in node.items() if b is not TERM}
            terminal = TERM in node
            if terminal and not children:
                return nxt
            s = self.dfa.new_state()
            for b, child in children.items():
                self.dfa.trans[s][b] = materialize(child)
            if terminal:
                self.dfa.also[s] = nxt
            return s

        return materialize(trie)

    def _array(self, schema: dict, nxt: int) -> int:
        item_schema = schema.get("items", {"type": "string"})
        # sep: after an item -> ',' item | ']' end. Allocate first, fill after
        sep = self.dfa.new_state()
        item_entry = self._value(item_schema, sep)
        self.dfa.trans[sep][0x2C] = item_entry  # ','
        self.dfa.trans[sep][0x5D] = nxt  # ']'
        entry = self.dfa.new_state()
        self.dfa.trans[entry][0x5B] = 0  # placeholder, set below
        first = self.dfa.new_state()
        # first position: either an item or an immediate close
        for b, t in self.dfa.trans[item_entry].items():
            self.dfa.trans[first][b] = t
        if self.dfa.default[item_entry] is not None:
            self.dfa.default[first] = self.dfa.default[item_entry]
        self.dfa.trans[first][0x5D] = nxt
        self.dfa.trans[entry][0x5B] = first
        return entry


def _all_token_texts(tokenizer) -> list[str | None]:
    """Every token's *in-context* text, in one pass.

    ``decode([tid])`` alone is wrong for sentencepiece/BPE vocabs: a token
    whose true text is " true" decodes standalone as "true", so the DFA
    would validate different bytes than the detokenizer later emits. For HF
    tokenizers we decode behind an anchor token and take the suffix, which
    preserves leading spaces exactly as they will appear in real output —
    and we do it with ONE ``batch_decode`` call (the per-token Python loop
    is what made 128k-vocab lifts cost minutes).
    """
    V = tokenizer.vocab_size
    hf = getattr(tokenizer, "_tok", None)
    if hf is None:
        out = []
        for tid in range(V):
            try:
                out.append(tokenizer.decode([tid]) or None)
            except Exception:
                out.append(None)
        return out
    anchor = hf.encode(":", add_special_tokens=False)
    if not anchor:
        texts = hf.batch_decode(
            [[tid] for tid in range(V)], skip_special_tokens=True
        )
        return [t or None for t in texts]
    a = anchor[0]
    base = hf.decode([a], skip_special_tokens=True)
    ctx = hf.batch_decode([[a, tid] for tid in range(V)], skip_special_tokens=True)
    solo = hf.batch_decode([[tid] for tid in range(V)], skip_special_tokens=True)
    return [
        (c[len(base):] if c.startswith(base) else s) or None
        for c, s in zip(ctx, solo)
    ]


class TokenGrammar:
    """Token-level lift of a JsonSchemaGrammar for a concrete tokenizer.

    Builds [n_states, vocab] transition (-1 = forbidden) and mask (bool)
    tables. Works with any tokenizer exposing ``decode([id])``; multi-byte
    tokens walk the char DFA transitively. The walk is vectorized over the
    whole (state × token) grid — one gather per byte position — so lifting
    a ~200-state tool grammar through a 128k vocab takes seconds, not
    minutes, and the table stores int16 when the state count fits (halving
    host and device bytes at Llama-3 vocab scale; ~50 MB for 200 states).
    ``lift_seconds`` / ``table_bytes`` record the measured cost.
    """

    def __init__(self, grammar: JsonSchemaGrammar, tokenizer):
        import time

        t0 = time.perf_counter()
        self.grammar = grammar
        self.tokenizer = tokenizer
        char_tab = grammar.char_table
        n_states = char_tab.shape[0]
        V = tokenizer.vocab_size

        texts = _all_token_texts(tokenizer)
        token_bytes = [
            t.encode("utf-8") if t else b"" for t in texts
        ]
        max_len = max((len(b) for b in token_bytes), default=0)
        # [V, max_len] byte matrix, -1 padded
        byte_mat = np.full((V, max_len), -1, dtype=np.int16)
        for tid, bs in enumerate(token_bytes):
            if bs:
                byte_mat[tid, : len(bs)] = np.frombuffer(bs, dtype=np.uint8)

        # walk all (state, token) pairs one byte position at a time
        S = np.broadcast_to(
            np.arange(n_states, dtype=np.int32)[:, None], (n_states, V)
        ).copy()
        for pos in range(max_len):
            b = byte_mat[:, pos].astype(np.int32)  # [V]
            has = (b >= 0)[None, :]
            nxt = char_tab[np.maximum(S, 0), np.maximum(b, 0)[None, :]]
            S = np.where(has & (S >= 0), nxt, np.where(has, -1, S))
        # tokens with no text (specials, undecodables) are never legal
        empty = np.array([not bs for bs in token_bytes])
        S[:, empty] = -1
        dtype = np.int16 if n_states < np.iinfo(np.int16).max else np.int32
        table = S.astype(dtype)

        # stop tokens are allowed in every *accepting* state: the accept
        # state itself plus any state whose also-fallback chain reaches it
        # (e.g. a top-level number's digit loop, which terminates on
        # "whatever follows" — at top level that is end-of-output)
        accept = grammar.accept
        table[accept, :] = -1
        accepting = {accept}
        for s in range(n_states):
            cur = grammar.dfa.also[s]
            while cur is not None:
                if cur == accept:
                    accepting.add(s)
                    break
                cur = grammar.dfa.also[cur]
        for s in accepting:
            for sid in tokenizer.stop_token_ids:
                table[s, sid] = accept
        self.accepting_states = accepting
        self.table = table
        self.mask_table = table >= 0
        self.entry = grammar.entry
        self.accept = grammar.accept
        self.min_dist = self._min_distances()
        self.lift_seconds = time.perf_counter() - t0
        self.table_bytes = self.table.nbytes

    def _min_distances(self) -> np.ndarray:
        """min_dist[s] = fewest tokens from state s to the accept state.

        Used for forced completion: when the remaining budget hits this
        distance, the mask is tightened to distance-decreasing tokens only,
        so constrained generation always closes its braces before the token
        budget runs out. unreachable states get a large sentinel."""
        n = self.table.shape[0]
        INF = np.int32(1 << 20)
        dist = np.full(n, INF, dtype=np.int32)
        dist[self.accept] = 0
        # Bellman-Ford over the token graph (n_states is small)
        for _ in range(n):
            tgt = np.where(self.table >= 0, self.table, 0)
            tgt_dist = np.where(self.table >= 0, dist[tgt], INF)
            best = tgt_dist.min(axis=1)
            new = np.minimum(dist, np.where(best >= INF, INF, best + 1))
            if np.array_equal(new, dist):
                break
            dist = new
        return dist

    def device_tables(self, vocab_size: int | None = None, device="cpu",
                      observer=None):
        """Transition + min-distance tables as torch tensors on ``device``
        for the on-device constrained decode (engine.generate_constrained,
        the scheduler's grammared step): mask = table[state] >= 0, state' =
        table[state, token]. Columns pad with -1 up to ``vocab_size`` (the
        model's vocab can exceed the tokenizer's); the table keeps its
        numpy dtype (int16 where the states fit).

        Memoized per (vocab_size, device): a multi-tool union table at 128k
        vocab is hundreds of MB, so it is uploaded once and lives as long
        as this TokenGrammar (the provider memoizes one per tool set).
        ``observer`` (an engine's ``CompileObserver``) counts the upload as
        a build of the table's content, so an upload of the same tables
        twice reads as a recompile."""
        dev = torch.device(device)
        cache = getattr(self, "_dev_tables", None)
        if cache is None:
            cache = self._dev_tables = {}
        key = (vocab_size, str(dev))
        if key not in cache:
            upload = self._upload_tables
            if observer is not None:
                upload = observer.wrap("grammar_table",
                                       (*self._signature(), *key), upload)
            cache[key] = upload(vocab_size, dev)
        return cache[key]

    def _upload_tables(self, vocab_size: int | None, dev):
        S, width = self.table.shape
        host = torch.from_numpy(np.ascontiguousarray(self.table))
        if vocab_size is not None and vocab_size > width:
            # the -1 padding is filled on the device: only the tokenizer's
            # columns cross from the host
            table = torch.full((S, vocab_size), -1, dtype=host.dtype, device=dev)
            table[:, :width] = host.to(dev)
        else:
            table = host.to(dev)
        return table, torch.from_numpy(self.min_dist).to(dev)

    def _signature(self) -> tuple:
        """The compile observer's signature: this grammar's serial and its
        tables' shape, so an upload of the same tables twice reads as a
        recompile (the provider memoizes one grammar per tool set). Cheap
        at any vocabulary: nothing of the tables is read."""
        serial = getattr(self, "_serial", None)
        if serial is None:
            serial = self._serial = next(_SERIALS)
        return (serial, *self.table.shape, self.entry, self.accept)

    def walk(self, token_ids: list[int]) -> int:
        """State after consuming ``token_ids`` from entry; -1 if rejected."""
        s = self.entry
        for t in token_ids:
            if s < 0:
                return -1
            s = int(self.table[s, t])
        return s

    def logit_mask_fn(
        self, max_tokens: int | None = None
    ) -> Callable[[list[int]], np.ndarray | None]:
        """Adapter for InferenceEngine.generate_stream(logit_mask_fn=…).

        Incremental: caches the DFA state per prefix length so each step is
        one table lookup, not a re-walk. With ``max_tokens`` set, forces
        completion: once the remaining budget equals the shortest path to
        accept, only distance-decreasing tokens stay legal.
        """
        state = {"len": 0, "s": self.entry}

        def fn(generated: list[int]) -> np.ndarray | None:
            if len(generated) < state["len"]:  # new generation / reset
                state["len"], state["s"] = 0, self.entry
            for t in generated[state["len"]:]:
                state["s"] = int(self.table[state["s"], t]) if state["s"] >= 0 else -1
            state["len"] = len(generated)
            s = state["s"]
            if s < 0:
                return None  # constraint already violated; stop masking
            if max_tokens is not None:
                # budget feasibility per edge: a token is only legal if its
                # target can still reach accept within the remaining budget.
                # Inductively dist[s] <= remaining, so the shortest-path edge
                # always survives — generation can never strand mid-grammar.
                return feasible_mask(
                    self.table[s], self.min_dist,
                    max_tokens - len(generated),
                )
            return self.mask_table[s]

        return fn


def compile_tool_call_grammar(tool_schema: dict, tokenizer) -> TokenGrammar:
    """Compile one tool's JSON-schema ``input_schema`` into token tables."""
    return TokenGrammar(JsonSchemaGrammar(tool_schema), tokenizer)


class ToolCallUnionGrammar(JsonSchemaGrammar):
    """Char DFA for a complete tool-call object over a REGISTRY of tools:

        {"name":"<registered tool>","arguments":{...that tool's schema...}}

    One DFA serves every registered tool: a trie branch over the tool names
    (closing quote included, so a name that prefixes another stays
    unambiguous) continues into that tool's own arguments grammar. This is
    the generation-side replacement for the reference's post-hoc schema
    validation (fei/tools/registry.py:92-153): the decoder cannot emit a
    call that fails validation in the first place.
    """

    def __init__(self, tools: list[dict]):
        if not tools:
            raise EngineError("tool-call grammar needs at least one tool")
        self.schema = None
        self.dfa = _DFA()
        self.accept = self.dfa.new_state()
        options: list[tuple[bytes, int]] = []
        seen: set[str] = set()
        for t in tools:
            name = t.get("name")
            if not name:
                raise EngineError(f"tool without a name: {t!r}")
            if name in seen:
                continue
            seen.add(name)
            schema = t.get("input_schema") or t.get("parameters") or {}
            if schema.get("type", "object") != "object":
                raise EngineError(
                    f"tool {name!r} input_schema must be an object, "
                    f"got {schema.get('type')!r}"
                )
            close = self.dfa.lit(b"}", self.accept)
            args_entry = self._object(
                {"type": "object", **schema}, close
            )
            tail = self.dfa.lit(b',"arguments":', args_entry)
            # the closing quote is part of the branch key: "Glob" vs
            # "GlobTool" then diverge at ‹"› vs ‹T› instead of colliding
            options.append((name.encode("utf-8") + b'"', tail))
        branch = self._branch(options)
        body = self.dfa.lit(b'{"name":"', branch)
        # models decorate the trigger tag with newlines ("<tool_call>\n{…")
        # — the post-hoc parser tolerates \s* there, so the grammar must
        # too or enforcement would silently disengage on the variant
        ws = self.dfa.new_state()
        for b in b" \t\r\n":
            self.dfa.trans[ws][b] = ws
        self.dfa.also[ws] = body
        self.entry = ws
        self.char_table = self.dfa.char_table()


def compile_agent_tool_grammar(tools: list[dict], tokenizer) -> TokenGrammar:
    """Token-level lift of the whole-registry tool-call grammar."""
    return TokenGrammar(ToolCallUnionGrammar(tools), tokenizer)


def feasible_mask(row, min_dist, remaining):
    """The ONE budget-feasibility masking rule, shared by every host and
    device call site (dense fused decode, scheduler step, first-token
    masks, host mask fns): a token is legal iff its DFA edge exists AND its
    target state can still reach accept within ``remaining - 1`` further
    tokens. Falls back to plain legality if feasibility empties the row
    (inductively impossible mid-walk; defensive at entry).

    ``row``: one table row [V] or a batch [B, V]; ``remaining``: scalar or
    [B]. numpy inputs give a numpy mask (host masks); torch tensors give a
    tensor on their device, computed there with no host sync."""
    batched = getattr(row, "ndim", 1) == 2
    if isinstance(row, torch.Tensor):
        legal = row >= 0
        tgt = torch.where(legal, row, torch.zeros_like(row)).long()
        rem = remaining - 1
        if batched:
            rem = rem[:, None]
        feasible = legal & (min_dist[tgt] <= rem)
        has = feasible.any(dim=-1, keepdim=batched)
        return torch.where(has, feasible, legal)
    legal = row >= 0
    tgt = np.where(legal, row, 0).astype(np.int32)
    rem = remaining - 1
    if batched:
        rem = rem[:, None]
    feasible = np.logical_and(legal, min_dist[tgt] <= rem)
    has = feasible.any(axis=-1, keepdims=batched)
    return np.where(has, feasible, legal)


def grammar_step(logits, table, min_dist, gstate, remaining, use=None):
    """One on-device DFA step of constrained decode, shared by the dense
    fused chunk (engine._grammar_fused_fn) and the scheduler's sampler:
    row = table[state], the budget-feasibility mask on ``logits`` [B, V],
    and, once the token is drawn, state' = row[token].

    ``gstate`` is int32 [B]; ``remaining`` an int32 tensor, scalar or [B].
    With ``use`` (bool [B]) given, rows where it is False (free phase, no
    grammar; their ``gstate`` may be -1) pass unmasked and keep their
    state and budget. Returns ``(masked_logits, advance)``, where
    ``advance(token [B])`` gives ``(gstate', remaining')``. No host sync."""
    row = table[(gstate if use is None else gstate.clamp(min=0)).long()]  # [B, V]
    rem = remaining.expand(row.shape[0]) if remaining.ndim == 0 else remaining
    mask = feasible_mask(row, min_dist, rem)
    if use is not None:
        mask = mask | ~use[:, None]
    masked = torch.where(mask, logits, float("-inf"))

    def advance(token):
        # the table may be int16; the carry state is int32
        nstate = row.gather(1, token[:, None].long())[:, 0].to(torch.int32)
        if use is None:
            return nstate, remaining - 1
        return torch.where(use, nstate, gstate), torch.where(use, remaining - 1, remaining)

    return masked, advance


def char_walk(grammar: TokenGrammar, text: str, start: int | None = None) -> int:
    """Walk raw TEXT through the char-level DFA (token boundaries don't
    matter). Returns the resulting state, or -1 if any byte is illegal.
    Used to enter the grammar mid-stream: the token that completed the
    ``<tool_call>`` trigger may have carried extra JSON bytes after it."""
    s = grammar.entry if start is None else start
    tab = grammar.grammar.char_table
    for b in text.encode("utf-8"):
        if s < 0:
            return -1
        s = int(tab[s, b])
    return s


class TriggerScanner:
    """Incremental detector for a trigger string in streamed token text.

    Each trigger OCCURRENCE is reported exactly once — at the step whose
    token completes its last character — as the text that followed it in
    that same step (usually empty; a BPE token can carry the first JSON
    bytes). A rejected occurrence is never re-examined: once the DFA
    refuses its suffix, every extension of that suffix is refused too, so
    re-walking it each step would only inflate metrics and burn host time.
    O(1) amortized per token; decoding uses a short token context so BPE
    pieces that merge across boundaries still contribute exact text.
    """

    def __init__(self, tokenizer, trigger: str, cap: int = 512):
        self.tok = tokenizer
        self.trigger = trigger
        self.ctx: list[int] = []
        self.text = ""
        self.search = 0
        self.cap = max(cap, 4 * len(trigger))

    def feed(self, token_id: int) -> str | None:
        """Consume one token; return the post-trigger suffix if a NEW
        trigger occurrence just completed (last one wins), else None."""
        base = self.tok.decode(self.ctx) if self.ctx else ""
        piece = self.tok.decode(self.ctx + [token_id])[len(base):]
        self.ctx = (self.ctx + [token_id])[-8:]
        if not piece:
            return None
        self.text += piece
        hit: str | None = None
        pos = self.text.find(self.trigger, self.search)
        while pos >= 0:
            hit = self.text[pos + len(self.trigger):]
            self.search = pos + 1
            pos = self.text.find(self.trigger, self.search)
        # never re-scan consumed text, but keep enough tail for a trigger
        # that is still streaming in
        self.search = max(self.search, len(self.text) - len(self.trigger) + 1)
        if len(self.text) > self.cap:
            drop = len(self.text) - self.cap
            self.text = self.text[drop:]
            self.search = max(0, self.search - drop)
        return hit


def toolcall_stream_mask_fn(
    grammar: TokenGrammar,
    tokenizer,
    trigger: str = "<tool_call>",
    max_tokens: int | None = None,
):
    """Stateful ``logit_mask_fn`` enforcing the tool-call protocol on a
    token stream: free generation until the decoded text emits ``trigger``,
    then the grammar's masks until the DFA accepts, then stop-tokens only
    (ending the turn — the agent protocol executes the call and continues
    in a fresh completion).

    Returns ``(fn, state)``; ``state["accepted"]`` tells the caller whether
    a complete tool call was emitted (so it can append the close tag).
    This is the host-mask route used by the paged/continuous-batching path;
    the dense path fuses the same DFA on device
    (InferenceEngine.generate_stream_toolcalls).
    """
    stop_mask = np.zeros(grammar.mask_table.shape[1], dtype=bool)
    for sid in tokenizer.stop_token_ids:
        if sid < stop_mask.shape[0]:
            stop_mask[sid] = True

    def _fresh() -> dict:
        return {
            "len": 0, "mode": "free", "s": -1, "accepted": False,
            "scanner": TriggerScanner(tokenizer, trigger),
        }

    state = _fresh()

    def fn(generated: list[int]) -> np.ndarray | None:
        if len(generated) < state["len"]:
            state.update(_fresh())
        new = generated[state["len"]:]
        state["len"] = len(generated)
        for t in new:
            if state["mode"] == "free":
                suffix = state["scanner"].feed(t)
                if suffix is not None:
                    s = char_walk(grammar, suffix)
                    if s == grammar.accept:  # whole call in one token
                        state.update(mode="done", accepted=True)
                    elif s >= 0:
                        state.update(mode="grammar", s=s)
            elif state["mode"] == "grammar":
                s = (
                    int(grammar.table[state["s"], t])
                    if state["s"] >= 0 else -1
                )
                state["s"] = s
                if s == grammar.accept:
                    state.update(mode="done", accepted=True)
        if state["mode"] == "done":
            return stop_mask if stop_mask.any() else None
        if state["mode"] != "grammar" or state["s"] < 0:
            return None  # free text, or walked off (impossible under masks)
        s = state["s"]
        if max_tokens is not None:
            return feasible_mask(
                grammar.table[s], grammar.min_dist,
                max_tokens - len(generated),
            )
        return grammar.mask_table[s]

    return fn, state
