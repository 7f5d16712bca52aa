"""The yardstick's operations and bytes against counts made by hand for
both configurations."""

from __future__ import annotations

import pytest

from portbench import roofline, spec

MISTRAL = spec.load_cell("mistral-7b.chat").model
MIXTRAL = spec.load_cell("mixtral-8x7b-int8.chat").model


def test_matmul_weights_per_token():
    attn = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096  # q, k, v, o
    mlp = 3 * 4096 * 14336
    assert roofline.matmul_params(MISTRAL) == 32 * (attn + mlp) == 6_979_321_856
    # two of eight experts, plus the router
    assert roofline.matmul_params(MIXTRAL) == 32 * (attn + 2 * mlp + 4096 * 8)
    assert roofline.head_params(MISTRAL) == 4096 * 32000


def test_attention_keys_under_the_window():
    assert roofline.span_keys(MISTRAL, 0, 4) == 1 + 2 + 3 + 4
    assert roofline.span_keys(MISTRAL, 4094, 4098) == 4095 + 4096 + 4096 + 4096
    assert roofline.span_keys(MISTRAL, 5000, 5003) == 3 * 4096
    assert roofline.span_keys(MIXTRAL, 5000, 5002) == 5001 + 5002
    # one decode token at context c reads min(c, W) keys
    assert roofline.span_attn_flops(MISTRAL, 9999, 10000) == 4 * 32 * 128 * 32 * 4096


def test_decode_and_prefill_bytes():
    kv = 2 * 32 * 8 * 128 * 2  # K and V, bf16, every layer
    qo = 2 * 32 * 32 * 128 * 2
    assert roofline.kv_bytes_per_token(MISTRAL) == kv
    assert roofline.decode_attn_bytes(MISTRAL, [100, 5000]) == kv * (100 + 4096) + 2 * qo
    assert roofline.prefill_attn_bytes(MIXTRAL, 0, 10) == 10 * (qo + kv)
    assert roofline.prefill_attn_bytes(MISTRAL, 6000, 6010) == 10 * (qo + kv) + 4096 * kv


def test_model_flops_and_mfu():
    n = 1000
    flops = roofline.model_flops(MISTRAL, n, n, 0.0)
    assert flops == 2 * (6_979_321_856 + 4096 * 32000) * n
    # 1000 tokens a second of Mistral is ~1.4% of the bf16 peak
    assert flops / roofline.PEAK_FLOPS * 100 == pytest.approx(1.438, abs=1e-3)


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)
