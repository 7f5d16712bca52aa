"""The weights and the traffic come from the seed alone: the same seed
gives the same tensors and requests, any tensor can be made again alone,
and every seed gets the same sizes of requests."""

from __future__ import annotations

import torch

from portbench import spec, traffic, weights
from portbench.tests import tiny
from portbench.spec import model_from_config

SEED = 2**31 + 12345


def test_weights_repeat_by_seed_and_differ_across_seeds():
    m = model_from_config("tiny", tiny.SWA)
    a = weights.program_params(m, SEED, "cpu")
    b = weights.program_params(m, SEED, "cpu")
    c = weights.program_params(m, SEED + 1, "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])


def test_any_tensor_is_made_again_alone():
    m = model_from_config("tiny", tiny.MOE)
    p = weights.program_params(m, SEED, "cpu")
    one = weights.draw(SEED, "layers.1.w_up", (4, 64, 128), 64, "cpu")
    assert torch.equal(p["layers"]["w_up"][1], one)
    layer = weights.draw_layer(m, SEED, 0, "cpu")
    assert torch.equal(p["layers"]["router"][0], layer["router"])
    assert torch.equal(p["lm_head"], weights.draw(SEED, "lm_head", (64, 512), 64, "cpu"))


def test_quantized_tree_matches_the_program_layout():
    from fei_tpu_torch.ops.quant import QTensor, quantize

    m = model_from_config("tiny", tiny.MOE)
    p = weights.program_params(m, SEED, "cpu", quantize)
    assert isinstance(p["layers"]["w_gate"], QTensor)
    assert p["layers"]["w_gate"].q.shape == (2, 4, 64, 128)
    assert p["layers"]["w_gate"].s.shape == (2, 4, 1, 128)
    assert isinstance(p["lm_head"], QTensor) and p["embed"].dtype == torch.bfloat16
    assert p["layers"]["router"].dtype == torch.bfloat16


def requests(kind: dict, seed: int, n: int):
    mix = traffic.make(kind, seed, 512)
    out, prev = [], {}
    for i in range(n):
        c = i % mix.clients
        r = mix.next(c, prev.get(c))
        prev[c] = (r.prompt, r.prompt[:3])
        out.append(r)
    return out


def test_traffic_repeats_by_seed():
    a = requests(tiny.CHAT, SEED, 40)
    b = requests(tiny.CHAT, SEED, 40)
    assert [(r.prompt, r.max_new) for r in a] == [(r.prompt, r.max_new) for r in b]


def test_every_seed_gets_the_same_sizes():
    a = requests(tiny.CHAT, SEED, traffic.POOL)  # one whole deck of each size
    b = requests(tiny.CHAT, SEED + 7, traffic.POOL)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    # the warm-start requests are cut to a share of their drawn output
    assert sorted(r.max_new for r in a[4:]) != [] and len(a) == len(b)
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_lengths_stay_in_their_clip():
    for r in requests(tiny.CHAT, SEED, 200):
        assert 8 <= len(r.prompt) <= 40 and 1 <= r.max_new <= 24


def test_the_chat_mix_has_its_sources_moments():
    """The committed mix's grids: the reply mean near the published one
    and its tail unclipped; prompts held to the program's chunk."""
    p = spec.read_json(spec.HERE / "traffic" / "chat.json")
    prompts, outputs = traffic.quantile_grid(p["prompt"]), traffic.quantile_grid(p["output"])
    unclipped = traffic.quantile_grid({**p["prompt"], "max": float("inf")})
    assert abs(sum(unclipped) / len(unclipped) - p["prompt"]["mean"]) < 0.1 * p["prompt"]["mean"]
    assert abs(sum(outputs) / len(outputs) - p["output"]["mean"]) < 0.1 * p["output"]["mean"]
    assert min(prompts) == 1 and max(prompts) == 256 and max(outputs) > 3000


def test_warm_lengths_cover_each_bucket_and_a_chunked_prompt():
    mix = traffic.make(spec.read_json(spec.HERE / "traffic" / "chat.json"), SEED, 32000)
    assert mix.warm_lengths(256) == [1, 16, 32, 64, 128, 256]
    warm = mix.warm_lengths(100)  # a smaller chunk: the shortest prompt over it too
    assert warm == [1, 16, 32, 64, 100, min(n for n in mix.prompt_grid if n > 100)]


def test_sample_takes_one_request_a_client_first():
    from portbench.client import Record
    from portbench.correctness import sample

    recs = [Record(c % 4, [1] * (5 + c), 10, float(c), tokens=[2] * 10) for c in range(12)]
    picked = sample(recs, SEED, 40)
    assert picked[0] is recs[-1] and len({r.client for r in picked}) == 4 == len(picked)
    assert len(sample(recs, SEED, 1000)) == 12
