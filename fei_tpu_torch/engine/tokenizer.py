"""Tokenizers for the local engine.

Two backends behind one interface:

- ``ByteTokenizer``: dependency-free byte-level tokenizer (ids = bytes + a
  small special-token block). Default for tests and random-weight benches;
  any text round-trips exactly.
- ``HFTokenizer``: wraps a local ``transformers`` tokenizer directory for
  real checkpoints (Llama-3 / CodeLlama / Mixtral vocab + chat template).
  Loaded lazily; never fetches from the network.

Both expose ``apply_chat_template(messages)`` so the provider layer is
backend-agnostic about prompt formatting.
"""

from __future__ import annotations

from typing import Sequence

from fei_tpu_torch.utils.errors import EngineError

# Special ids for ByteTokenizer. Byte b maps to id OFFSET + b.
PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
# Role/turn markers for the builtin chat template.
HDR_START_ID = 3  # <|start_header|>
HDR_END_ID = 4  # <|end_header|>
EOT_ID = 5  # <|eot|> end of turn
_BYTE_OFFSET = 8


class ByteTokenizer:
    """UTF-8 byte tokenizer: vocab = 8 specials + 256 bytes = 264 ids."""

    vocab_size = _BYTE_OFFSET + 256
    bos_token_id = BOS_ID
    eos_token_id = EOS_ID
    eot_token_id = EOT_ID
    pad_token_id = PAD_ID

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [_BYTE_OFFSET + b for b in text.encode("utf-8")]
        return ([BOS_ID] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - _BYTE_OFFSET for i in ids if _BYTE_OFFSET <= i < _BYTE_OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")

    @property
    def stop_token_ids(self) -> list[int]:
        return [EOS_ID, EOT_ID]

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True
    ) -> list[int]:
        """Llama-3-shaped turn structure with byte-level content:
        <bos> then per message <hdr>role</hdr>content<eot>."""
        ids = [BOS_ID]
        for msg in messages:
            ids.append(HDR_START_ID)
            ids.extend(self.encode(str(msg.get("role", "user"))))
            ids.append(HDR_END_ID)
            ids.extend(self.encode(str(msg.get("content", ""))))
            ids.append(EOT_ID)
        if add_generation_prompt:
            ids.append(HDR_START_ID)
            ids.extend(self.encode("assistant"))
            ids.append(HDR_END_ID)
        return ids


class HFTokenizer:
    """Local HuggingFace tokenizer wrapper (no network access)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        except Exception as e:  # pragma: no cover - depends on local files
            raise EngineError(f"failed to load tokenizer from {path}: {e}", cause=e)
        self.vocab_size = len(self._tok)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or 0

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    @property
    def stop_token_ids(self) -> list[int]:
        ids = [self.eos_token_id]
        # llama-3 end-of-turn
        eot = self._tok.convert_tokens_to_ids("<|eot_id|>")
        if isinstance(eot, int) and eot >= 0 and eot != self._tok.unk_token_id:
            ids.append(eot)
        return [i for i in ids if i is not None]

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True
    ) -> list[int]:
        return self._tok.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt, tokenize=True
        )


def load_tokenizer(spec: str | None):
    """'byte' / None -> ByteTokenizer; anything else is a local HF path."""
    if not spec or spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
