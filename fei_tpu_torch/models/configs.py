"""Model configurations for the fei_tpu_torch engine (a copy of
fei_tpu.models.configs: the port imports nothing of the JAX package).

Covers the model families named in BASELINE.json configs: Llama-3 (8B/70B),
CodeLlama-34B, Mixtral-8x7B MoE — plus tiny presets for hermetic CPU tests.
All are decoder-only transformers with RMSNorm, RoPE, SwiGLU MLPs, and
grouped-query attention; Mixtral swaps the dense MLP for a top-2 router over
8 experts.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 512
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # MoE (Mixtral): num_experts == 0 means dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Qwen2-family attention: q/k/v projections carry biases (o does not)
    attn_bias: bool = False
    # HF Llama-family `attention_bias: true` additionally biases o_proj
    o_bias: bool = False
    # Gemma family: RMSNorm multiplies by (1 + w) (weights stored
    # zero-centered), embeddings scale by sqrt(hidden_size), GeGLU MLP
    norm_offset: bool = False
    embed_scale: bool = False
    hidden_act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU, tanh approx)
    # Mistral-v0.1-style sliding-window attention: each query attends to at
    # most the last `sliding_window` positions (None = full causal)
    sliding_window: int | None = None
    # Phi family: LayerNorm (with bias) instead of RMSNorm, ONE shared norm
    # feeding attention AND MLP in parallel (x + attn(ln x) + mlp(ln x)),
    # partial rotary (first `rotary_dim` dims of each head), non-gated
    # fc1/act/fc2 MLP with biases, and a biased LM head
    norm_kind: str = "rms"  # "rms" | "layernorm"
    parallel_block: bool = False
    rotary_dim: int = 0  # 0 = rotate the full head_dim
    mlp_gated: bool = True
    mlp_bias: bool = False
    lm_head_bias: bool = False
    # tokenizer/bos/eos defaults (overridden by a real tokenizer when loaded)
    bos_token_id: int = 1
    eos_token_id: int = 2

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def rope_dim_(self) -> int:
        """Head dims that rotate: `rotary_dim` when partial (Phi), else all."""
        return self.rotary_dim or self.head_dim_

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Approximate parameter count (for memory planning)."""
        h, i, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        d = self.head_dim_
        attn = h * (self.num_heads * d) + 2 * h * (self.num_kv_heads * d) + (self.num_heads * d) * h
        if self.attn_bias:
            attn += self.num_heads * d + 2 * self.num_kv_heads * d
        if self.o_bias:
            attn += h
        if self.is_moe:
            mlp = self.num_experts * 3 * h * i + h * self.num_experts
        else:
            mlp = (3 if self.mlp_gated else 2) * h * i
        norms = (1 if self.parallel_block else 2) * h
        embed = v * h * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + norms) + embed + h

    def num_active_params(self) -> int:
        """Parameters that participate in MATMULS for one decoded token —
        the right basis for FLOPs/token (≈ 2·active): only the top-k
        experts run, the embedding lookup is a gather (not a matmul), and
        the LM head is one h×v matmul whether tied or not."""
        h, i, v, L = (
            self.hidden_size, self.intermediate_size, self.vocab_size,
            self.num_layers,
        )
        d = self.head_dim_
        attn = (
            h * (self.num_heads * d)
            + 2 * h * (self.num_kv_heads * d)
            + (self.num_heads * d) * h
        )
        if self.is_moe:
            mlp = self.num_experts_per_tok * 3 * h * i + h * self.num_experts
        else:
            mlp = (3 if self.mlp_gated else 2) * h * i
        return L * (attn + mlp) + v * h


# Shapes follow the published architecture cards for each family. These are
# architectural constants (layer/head/dim counts), not code from the reference
# repo — the reference has no model code at all (SURVEY.md §2: LLM calls go out
# over HTTP via LiteLLM, fei/core/assistant.py:524-530).
MODEL_CONFIGS: dict[str, ModelConfig] = {
    # hermetic-test presets
    "tiny": ModelConfig(),
    "debug": ModelConfig(
        name="debug", vocab_size=512, hidden_size=128, intermediate_size=256,
        num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=2048,
    ),
    "tiny-moe": ModelConfig(
        name="tiny-moe", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, num_experts=4,
        num_experts_per_tok=2, max_seq_len=2048,
    ),
    # benchmark-scale presets (weights random-init unless a checkpoint is given)
    "llama3-1b": ModelConfig(
        name="llama3-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        rope_theta=500000.0, max_seq_len=8192, tie_embeddings=True,
        bos_token_id=128000, eos_token_id=128009,
    ),
    "llama3-3b": ModelConfig(
        name="llama3-3b", vocab_size=128256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        rope_theta=500000.0, max_seq_len=8192, tie_embeddings=True,
        bos_token_id=128000, eos_token_id=128009,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=500000.0, max_seq_len=8192,
        bos_token_id=128000, eos_token_id=128009,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
        rope_theta=500000.0, max_seq_len=8192,
        bos_token_id=128000, eos_token_id=128009,
    ),
    "codellama-34b": ModelConfig(
        name="codellama-34b", vocab_size=32000, hidden_size=8192,
        intermediate_size=22016, num_layers=48, num_heads=64, num_kv_heads=8,
        rope_theta=1000000.0, max_seq_len=16384,
    ),
    # bench-scale MoE: Mixtral routing shape (8 experts, top-2) at a size a
    # single 16 GB v5e chip holds in bf16 (~1.9B params), for measuring the
    # routed-vs-dense expert paths on real hardware
    "moe-2b": ModelConfig(
        name="moe-2b", vocab_size=32000, hidden_size=2048,
        intermediate_size=2048, num_layers=16, num_heads=16, num_kv_heads=8,
        rope_theta=1000000.0, max_seq_len=8192,
        num_experts=8, num_experts_per_tok=2,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=1000000.0, max_seq_len=32768,
        num_experts=8, num_experts_per_tok=2,
    ),
    # Qwen2 family (qkv biases; otherwise the same pre-norm GQA block)
    "tiny-bias": ModelConfig(
        name="tiny-bias", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        max_seq_len=2048, attn_bias=True,
    ),
    # Mistral family (Llama block + sliding-window attention)
    "tiny-swa": ModelConfig(
        name="tiny-swa", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        max_seq_len=2048, sliding_window=8, rope_theta=10000.0,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=10000.0, max_seq_len=32768, sliding_window=4096,
    ),
    # Phi family (parallel attn+MLP block, LayerNorm, partial rotary)
    "tiny-phi": ModelConfig(
        name="tiny-phi", vocab_size=512, hidden_size=64,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
        max_seq_len=2048, rope_theta=10000.0, norm_kind="layernorm",
        parallel_block=True, rotary_dim=8, mlp_gated=False, mlp_bias=True,
        attn_bias=True, o_bias=True, lm_head_bias=True, hidden_act="gelu",
    ),
    "phi-2": ModelConfig(
        name="phi-2", vocab_size=51200, hidden_size=2560,
        intermediate_size=10240, num_layers=32, num_heads=32, num_kv_heads=32,
        max_seq_len=2048, rope_theta=10000.0, norm_kind="layernorm",
        parallel_block=True, rotary_dim=32, mlp_gated=False, mlp_bias=True,
        attn_bias=True, o_bias=True, lm_head_bias=True, hidden_act="gelu",
        bos_token_id=50256, eos_token_id=50256,
    ),
    # Gemma family (norm offset, GeGLU, scaled embeddings, head_dim 256,
    # always-tied embeddings, rope 10000)
    "tiny-gemma": ModelConfig(
        name="tiny-gemma", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, max_seq_len=2048, tie_embeddings=True,
        norm_offset=True, embed_scale=True, hidden_act="gelu",
        rope_theta=10000.0,
    ),
    "gemma-2b": ModelConfig(
        name="gemma-2b", vocab_size=256000, hidden_size=2048,
        intermediate_size=16384, num_layers=18, num_heads=8, num_kv_heads=1,
        head_dim=256, rope_theta=10000.0, max_seq_len=8192,
        tie_embeddings=True, norm_offset=True, embed_scale=True,
        hidden_act="gelu", bos_token_id=2, eos_token_id=1,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b", vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_layers=28, num_heads=16, num_kv_heads=16,
        head_dim=256, rope_theta=10000.0, max_seq_len=8192,
        tie_embeddings=True, norm_offset=True, embed_scale=True,
        hidden_act="gelu", bos_token_id=2, eos_token_id=1,
    ),
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b", vocab_size=151936, hidden_size=896,
        intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
        rope_theta=1000000.0, max_seq_len=32768, tie_embeddings=True,
        attn_bias=True, bos_token_id=151643, eos_token_id=151645,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        rope_theta=1000000.0, max_seq_len=32768,
        attn_bias=True, bos_token_id=151643, eos_token_id=151645,
    ),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(MODEL_CONFIGS)}")
    cfg = MODEL_CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
