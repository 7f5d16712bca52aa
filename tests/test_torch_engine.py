"""The port's dense engine: greedy token identity with the JAX
InferenceEngine on the same fp32 tiny weights, and the engine's own
contracts re-proved inside the port — chunk=1 == chunked, the post-stop
freeze of the fused decode (key included), budget truncation, and seeded
sampling (top-k=1 is greedy; on the same threefry key the port draws the
JAX sampler's tokens, whose set is the filtered support). The seeded
streams of the two engines are held against each other in
tests/test_torch_seeded_parity.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.sampling import sample_logits as jax_sample
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.prng import PRNGKey
from fei_tpu_torch.engine.sampling import filter_logits, sample_logits
from fei_tpu_torch.engine.tokenizer import load_tokenizer
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.errors import EngineError

MAX_SEQ = 128


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def engine(jax_engine):
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.params))
    return InferenceEngine(
        get_model_config("tiny"), params, load_tokenizer("byte"),
        max_seq_len=MAX_SEQ, dtype=torch.float32, device="cpu",
    )


def _tokens(engine, prompt, n, **kw):
    gen = GenerationConfig(max_new_tokens=n, ignore_eos=True, **kw)
    return list(engine.generate_stream(prompt, gen))


@pytest.mark.parametrize("chunk", [1, 16])
def test_greedy_tokens_match_jax_engine(jax_engine, engine, chunk):
    prompt = engine.tokenizer.encode("port parity", add_bos=True)
    want = list(jax_engine.generate_stream(
        prompt, JaxGen(max_new_tokens=24, ignore_eos=True)))
    assert _tokens(engine, prompt, 24, chunk=chunk) == want


@pytest.mark.parametrize(
    "kw", [{}, {"temperature": 0.9, "top_k": 40, "seed": 7}], ids=["greedy", "seeded"]
)
def test_chunk1_equals_chunk5(engine, kw):
    prompt = engine.tokenizer.encode("chunk parity", add_bos=True)
    assert _tokens(engine, prompt, 23, chunk=1, **kw) == _tokens(
        engine, prompt, 23, chunk=5, **kw)


def test_fused_decode_freezes_after_stop(engine):
    """Once the stop is sampled, later steps leave cache.length, the KV
    slots and the key unchanged and repeat the carry token."""
    prompt = engine.tokenizer.encode("device stop", add_bos=True)
    full = _tokens(engine, prompt, 12, chunk=1)
    # the fused chunk samples full[1:]; pick a step j whose token is new
    j = next(j for j in range(2, 8) if full[1 + j] not in full[: 1 + j])
    stop_at = full[1 + j]
    gen = GenerationConfig(max_new_tokens=12, stop_token_ids=(stop_at,))
    tok, cache, key = engine._prefill_sample(prompt, gen)
    assert int(tok[0]) == full[0]
    k_before, v_before = cache.k.clone(), cache.v.clone()
    fused = engine._free_fused_fn(gen, 10)
    done = torch.zeros((1,), dtype=torch.bool)
    toks, cache, token, key, done, keys = fused(
        engine.params, cache, tok.reshape(1, 1), key, done,
        torch.tensor([stop_at], dtype=torch.int32),
    )
    host = toks[0].tolist()
    assert host[: j + 1] == full[1: j + 2]
    assert all(t == stop_at for t in host[j:])
    assert bool(done[0]) and int(token[0, 0]) == stop_at
    assert keys is None and torch.equal(key, PRNGKey(0))  # greedy: no split
    # sampled: the per-step keys, the last one the carried key, frozen
    # from the step after the stop (its dead steps split nothing)
    sgen = GenerationConfig(max_new_tokens=12, temperature=0.9, seed=4)
    stok, scache, skey = engine._prefill_sample(prompt, sgen)
    done = torch.zeros((1,), dtype=torch.bool)
    stoks, _, _, skey, done, keys = engine._free_fused_fn(sgen, 10)(
        engine.params, scache, stok.reshape(1, 1), skey, done,
        torch.tensor([stop_at], dtype=torch.int32),
    )
    assert keys.shape == (10, 2) and torch.equal(keys[-1], skey)
    if bool(done[0]):
        j = stoks[0].tolist().index(stop_at)
        assert all(torch.equal(keys[i], keys[j]) for i in range(j, 10))
    fed = len(prompt) + j + 1  # the stop itself is never fed
    assert int(cache.length[0]) == fed
    assert torch.equal(cache.k[:, :, fed:], k_before[:, :, fed:])
    assert torch.equal(cache.v[:, :, fed:], v_before[:, :, fed:])


@pytest.mark.parametrize("chunk", [1, 8])
def test_budget_truncation(engine, chunk):
    prompt = [9] * 100  # cache room: 128 - 100 = 28 tokens
    assert len(_tokens(engine, prompt, 64, chunk=chunk)) == MAX_SEQ - len(prompt)
    assert len(_tokens(engine, prompt, 7, chunk=chunk)) == 7


def test_generate_and_chat_results(engine):
    prompt = engine.tokenizer.encode("result", add_bos=True)
    res = engine.generate(prompt, GenerationConfig(max_new_tokens=6, ignore_eos=True))
    assert res.token_ids == _tokens(engine, prompt, 6)
    assert res.prompt_tokens == len(prompt) and res.ttft_s >= 0
    fused = engine.generate_fused(prompt, GenerationConfig(max_new_tokens=6, ignore_eos=True), chunk=4)
    assert fused.token_ids == res.token_ids
    chat = engine.chat([{"role": "user", "content": "hi"}],
                       GenerationConfig(max_new_tokens=4, ignore_eos=True))
    assert len(chat.token_ids) == 4


def test_top_k_1_is_greedy(engine):
    prompt = engine.tokenizer.encode("top k one", add_bos=True)
    assert _tokens(engine, prompt, 16, temperature=0.8, top_k=1, seed=5) == _tokens(
        engine, prompt, 16)


def test_seed_reproducible(engine):
    prompt = engine.tokenizer.encode("seeded", add_bos=True)
    a = _tokens(engine, prompt, 16, temperature=1.0, seed=11)
    assert a == _tokens(engine, prompt, 16, temperature=1.0, seed=11)
    assert a != _tokens(engine, prompt, 16, temperature=1.0, seed=12)


@pytest.mark.parametrize(
    "knobs",
    [
        dict(temperature=1.0, top_k=5),
        dict(temperature=0.7, top_p=0.7),
        dict(temperature=1.3, min_p=0.2),
        dict(temperature=1.0, top_k=8, top_p=0.9, min_p=0.05),
    ],
    ids=["top_k", "top_p", "min_p", "combined"],
)
def test_sampled_support_matches_jax(knobs):
    """Over N draws on a 16-token vocab with one threefry key, the port and
    the JAX sampler draw the same tokens, and their set is the port's
    filtered support."""
    n, V = 4000, 16
    logits = (np.random.default_rng(0).standard_normal(V) * 1.5).astype(np.float32)
    jax_ids = jax_sample(jnp.tile(jnp.asarray(logits), (n, 1)),
                         jax.random.PRNGKey(0), **knobs)
    pt_ids = sample_logits(torch.from_numpy(logits).repeat(n, 1), PRNGKey(0), **knobs)
    support = torch.isfinite(filter_logits(torch.from_numpy(logits)[None], **knobs)[0])
    assert np.asarray(jax_ids).tolist() == pt_ids.tolist()
    assert set(pt_ids.tolist()) == set(torch.nonzero(support)[:, 0].tolist())


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(EngineError, match="CUDA is not available"):
        InferenceEngine.from_config("tiny")


def test_later_slices_raise(monkeypatch):
    """Weight quantization is ported (int8/int4) and only a mode that does
    not exist raises. MoE is ported (C2): a ``tiny-moe`` engine builds and
    decodes on the CPU; expert parallelism over a mesh is ported too (C4):
    ``_moe`` given an ep mesh takes the routed ep form at the default
    capacity, and ``FEI_TPU_ROUTED_MOE=0`` still takes the oracle."""
    from fei_tpu_torch.models import llama as pt_llama
    from fei_tpu_torch.ops.moe import moe_mlp
    from fei_tpu_torch.parallel import expert as pt_expert
    from fei_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(EngineError, match="unsupported quantize mode"):
        InferenceEngine.from_config("tiny", device="cpu", quantize="int2")
    eng = InferenceEngine.from_config("tiny-moe", device="cpu", dtype=torch.float32,
                                      max_seq_len=64)
    assert eng.cfg.is_moe and "router" in eng.params["layers"]
    gen = GenerationConfig(max_new_tokens=5, ignore_eos=True)
    assert len(eng.generate([1, 2, 3], gen).token_ids) == 5
    lp = pt_llama.layer_params(eng.params, 0)
    seen = []
    monkeypatch.setattr(pt_expert, "moe_mlp_ep_routed",
                        lambda *a, **kw: seen.append(kw) or torch.zeros_like(a[0]))
    y = torch.randn((1, 2, eng.cfg.hidden_size))
    pt_llama._moe(eng.cfg, y, lp, True, moe_mesh=Mesh({"ep": 2}))
    assert seen == [dict(capacity_factor=2.0, tp_axis=None,
                         intermediate_size=eng.cfg.intermediate_size)]
    monkeypatch.setenv("FEI_TPU_ROUTED_MOE", "0")
    got = pt_llama._moe(eng.cfg, y, lp, True, moe_mesh=Mesh({"ep": 2}))
    want = moe_mlp(y, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                   eng.cfg.num_experts_per_tok)
    assert len(seen) == 1 and torch.equal(got, want)


def test_torch_local_config_section(tmp_path):
    """[torch_local] carries the [jax_local] options; env overrides use the
    FEI_TPU_TORCH_LOCAL_ prefix."""
    from fei_tpu_torch.utils.config import CONFIG_SCHEMA, Config

    assert set(CONFIG_SCHEMA["torch_local"]) == set(CONFIG_SCHEMA["jax_local"])
    cfg = Config(config_path=str(tmp_path / "fei.ini"), env_files=[],
                 environ={"FEI_TPU_TORCH_LOCAL_MODEL": "tiny"})
    assert cfg.get("torch_local", "model") == "tiny"
    assert cfg.get("torch_local", "max_seq_len") == 8192


def test_provider_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from fei_tpu_torch.agent.providers import TorchLocalProvider

    with pytest.raises(EngineError, match="CUDA is not available"):
        TorchLocalProvider(model="tiny")


def test_logit_mask_fn_constrains_per_token_decode(engine):
    """A host logit mask (tokenizer-vocab wide, padded to the model vocab)
    forces the per-token loop and only allowed ids are sampled."""
    from fei_tpu_torch.engine.engine import pad_vocab_mask

    allowed = [40, 41, 42]
    mask = np.zeros(engine.tokenizer.vocab_size, dtype=bool)
    mask[allowed] = True
    prompt = engine.tokenizer.encode("masked", add_bos=True)
    out = list(engine.generate_stream(
        prompt, GenerationConfig(max_new_tokens=8, ignore_eos=True, temperature=1.0),
        logit_mask_fn=lambda generated: mask,
    ))
    assert len(out) == 8 and set(out) <= set(allowed)
    assert pad_vocab_mask(mask, 512).shape == (512,)
    with pytest.raises(EngineError, match="exceeds model vocab"):
        pad_vocab_mask(np.ones(600, dtype=bool), 512)


def test_chunked_dispatch_count_bounded(engine):
    """A B-token fused run costs at most ceil(B/chunk)+1 host dispatches
    (the +1 is the pipelined chunk in flight)."""
    from fei_tpu_torch.utils.metrics import METRICS

    prompt = engine.tokenizer.encode("count dispatches", add_bos=True)
    before = METRICS.snapshot()["counters"].get("engine.decode_dispatches", 0)
    assert len(_tokens(engine, prompt, 48, chunk=8)) == 48
    after = METRICS.snapshot()["counters"].get("engine.decode_dispatches", 0)
    assert after - before <= 48 // 8 + 1
