"""Quantized weights through the port's model, loader and engines, against
fei_tpu on the same weights (JAX ``init_params(quantize=...)`` ->
numpy -> ``params_from_jax``), fp32 on the CPU.

The model is the tiny config widened to h = 512, I = 1024, 8/4 heads, 2
layers, so every linear's contraction divides by 256 and takes int4.
- int8: logits atol 1e-4 (two layers of matmuls summed in different
  orders), greedy tokens identical.
- int4: logits within 1e-2 · max|logit|. Both packages round x to bf16
  inside an int4 linear (the kernel's contract), and an fp32 sum-order
  difference upstream can move an x across a bf16 rounding boundary, so
  the two logits differ by a bf16 step of x times the weights, not by fp32
  noise. Decode is teacher-forced on the JAX tokens for that reason.
- Checkpoint loads: packed bytes bit-equal, scales rtol 1e-6.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.paged_cache import PagedKVCache as JaxPool
from fei_tpu.models import llama as jl
from fei_tpu.models.configs import get_model_config as jax_cfg
from fei_tpu.ops import quant as jq
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.models import llama as tl
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ops import quant as pq
from fei_tpu_torch.utils.errors import EngineError

WIDE = dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4)
S = 64  # cache length


def _close(got, want, mode):
    got, want = got.numpy(), np.asarray(want)
    if mode == "int8":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(), rtol=0)


def _setup(mode, name="tiny", monkeypatch=None, quant_embed=False, **over):
    jcfg, cfg = jax_cfg(name, **WIDE, **over), get_model_config(name, **WIDE, **over)
    if monkeypatch is not None:  # the JAX package reads its opt-in from the environment
        monkeypatch.setenv("FEI_TPU_QUANT_EMBED", "1" if quant_embed else "0")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32, quantize=mode)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams))


def _kinds(params):
    return {k: type(v).__name__ for k, v in {**params["layers"], **params}.items()
            if k != "layers"}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_forward_logits_match_jax(mode):
    jcfg, jparams, cfg, params = _setup(mode)
    want_kind = "QTensor4" if mode == "int4" else "QTensor"
    kinds = _kinds(params)
    assert all(kinds[k] == want_kind for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                              "w_down"))
    assert kinds["lm_head"] == "QTensor" and kinds["embed"] == "Tensor"
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(toks), jl.KVCache.create(jcfg, 2, S,
                                                                             jnp.float32))
    got, cache = tl.forward(params, cfg, torch.from_numpy(toks),
                            tl.KVCache.create(cfg, 2, S, torch.float32))
    assert cache.length.tolist() == [20, 20]
    _close(got, want, mode)


def test_quantized_embed_and_tied_head_match_jax(monkeypatch):
    """quant_embed (the JAX package's FEI_TPU_QUANT_EMBED=1) with a tied LM
    head: the lookup and the logits go through the row-quantized table."""
    jcfg, jparams, cfg, params = _setup("int8", monkeypatch=monkeypatch, quant_embed=True,
                                        tie_embeddings=True)
    assert isinstance(params["embed"], pq.QTensor) and "lm_head" not in params
    assert tl.model_dtype(params) == torch.float32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(toks), jl.KVCache.create(jcfg, 1, S,
                                                                             jnp.float32))
    got, _ = tl.forward(params, cfg, torch.from_numpy(toks),
                        tl.KVCache.create(cfg, 1, S, torch.float32))
    _close(got, want, "int8")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_matches_jax(mode):
    """A 10-token prefill, then 12 decode steps: int8 greedy tokens chosen
    by each package on its own are identical; int4 steps feed both the JAX
    package's tokens and compare the logits."""
    jcfg, jparams, cfg, params = _setup(mode)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    jlog, jcache = jl.forward(jparams, jcfg, jnp.asarray(prompt),
                              jl.KVCache.create(jcfg, 1, S, jnp.float32))
    tlog, tcache = tl.forward(params, cfg, torch.from_numpy(prompt),
                              tl.KVCache.create(cfg, 1, S, torch.float32))
    jtoks, ttoks = [], []
    for _ in range(12):
        _close(tlog[:, -1], jlog[:, -1], mode)
        jtok = int(jnp.argmax(jlog[0, -1]))
        ttok = int(tlog[0, -1].argmax()) if mode == "int8" else jtok
        jtoks.append(jtok)
        ttoks.append(ttok)
        jlog, jcache = jl.forward(jparams, jcfg, jnp.asarray([[jtok]], jnp.int32), jcache)
        tlog, tcache = tl.forward(params, cfg, torch.tensor([[ttok]]), tcache)
    assert ttoks == jtoks


PS, WIDTH, NUM_PAGES, B = 16, 6, 20, 2
TABLE = np.array([[4, 9, 2, 11, 0, 0], [7, 1, 13, 5, 16, 0]], np.int32)


def _pools(jcfg, cfg):
    jpool = JaxPool.create(jcfg, NUM_PAGES, B, WIDTH, page_size=PS, dtype=jnp.float32)
    tpool = PagedKVCache.create(cfg, NUM_PAGES, B, WIDTH, page_size=PS, dtype=torch.float32)
    return (jpool._replace(block_table=jnp.asarray(TABLE)),
            tpool._replace(block_table=torch.from_numpy(TABLE)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_paged_block_and_merged_match_jax(mode):
    """forward_paged_block (a 17-token block per row, then one decode step)
    and forward_paged_merged (row 0 decodes while a 13-token chunk of row
    1 rides the dispatch in groups of 4) on quantized weights."""
    jcfg, jparams, cfg, params = _setup(mode)
    jpool, tpool = _pools(jcfg, cfg)
    rng = np.random.default_rng(3)
    pre = rng.integers(1, cfg.vocab_size, (B, 17)).astype(np.int32)
    jlog, jpool = jl.forward_paged_block(jparams, jcfg, jnp.asarray(pre), jpool)
    tlog, tpool = tl.forward_paged_block(params, cfg, torch.from_numpy(pre), tpool)
    _close(tlog, jlog, mode)
    step = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
    jlog, _ = jl.forward_paged(jparams, jcfg, jnp.asarray(step), jpool)
    tlog, _ = tl.forward_paged(params, cfg, torch.from_numpy(step), tpool)
    _close(tlog, jlog, mode)

    live = TABLE.copy()
    live[1] = 0  # row 1 is the admitting slot
    lengths = np.array([17, 0], np.int32)
    jpool = jpool._replace(block_table=jnp.asarray(live), lengths=jnp.asarray(lengths))
    tpool = tpool._replace(block_table=torch.from_numpy(live), lengths=torch.from_numpy(lengths))
    chunk = rng.integers(1, cfg.vocab_size, (1, 13)).astype(np.int32)
    dec = np.array([[5], [0]], np.int32)
    jh, jlog, _ = jl.forward_paged_merged(
        jparams, jcfg, jnp.asarray(chunk), jnp.asarray(TABLE[1:2]),
        jnp.asarray([16], jnp.int32), jnp.asarray(dec), jpool, rows=4)
    th, tlog, _ = tl.forward_paged_merged(
        params, cfg, torch.from_numpy(chunk), torch.from_numpy(TABLE[1:2]), 16,
        torch.from_numpy(dec), tpool, rows=4)
    _close(th, jh, mode)
    _close(tlog[:1], jlog[:1], mode)


# ------------------------------------------------------------- checkpoint

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf_llama_q")
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(str(path), safe_serialization=True)
    return str(path)


def _leaves(params):
    out = {f"layers/{k}": v for k, v in params["layers"].items()}
    out.update({k: v for k, v in params.items() if k != "layers"})
    return out


@pytest.mark.parametrize("mode,quant_embed", [("int4", False), ("int8", True)],
                         ids=["int4", "int8+embed"])
def test_load_checkpoint_bytes_match_jax(hf_dir, mode, quant_embed, monkeypatch):
    from fei_tpu.engine.weights import load_checkpoint as jax_load
    from fei_tpu_torch.engine.weights import load_checkpoint

    monkeypatch.setenv("FEI_TPU_QUANT_EMBED", "1" if quant_embed else "0")
    jcfg, jparams = jax_load(hf_dir, jax_cfg("tiny"), dtype=jnp.float32, quantize=mode)
    cfg, params = load_checkpoint(hf_dir, get_model_config("tiny"), dtype=torch.float32,
                                  quantize=mode, quant_embed=quant_embed)
    assert vars(cfg) == vars(jcfg)
    want, got = _leaves(jax.tree.map(np.asarray, jparams)), _leaves(params)
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert type(leaf).__name__ == type(want[key]).__name__.replace("ndarray", "Tensor"), key
        if isinstance(leaf, tuple):
            np.testing.assert_array_equal(leaf[0].numpy(), want[key][0], err_msg=key)
            np.testing.assert_allclose(leaf.s.numpy(), want[key].s, rtol=1e-6, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want[key], err_msg=key)
    assert isinstance(params["lm_head"], pq.QTensor)  # lm_head stays int8
    if mode == "int4":
        assert isinstance(params["layers"]["w_down"], pq.QTensor4)
    assert isinstance(params["embed"], pq.QTensor if quant_embed else torch.Tensor)
    # the loaded tree runs: logits agree with the JAX package's on it
    toks = np.array([[5, 6, 7, 100]], np.int32)
    jlog, _ = jl.forward(jparams, jcfg, jnp.asarray(toks), jl.KVCache.create(jcfg, 1, 8,
                                                                             jnp.float32))
    tlog, _ = tl.forward(params, cfg, torch.from_numpy(toks),
                         tl.KVCache.create(cfg, 1, 8, torch.float32))
    _close(tlog, jlog, mode)


# ----------------------------------------------------------------- engine

ENGINE_KW = dict(device="cpu", dtype=torch.float32, max_seq_len=128, num_layers=2, **WIDE)


def test_engine_int4_dense_and_paged_streams_agree():
    """The int4 engine serves the dense path and the paged path: two
    concurrent paged greedy streams equal the dense engine's (the JAX
    contract ``test_paged_scheduler_serves_int4``)."""
    dense = InferenceEngine.from_config("tiny", quantize="int4", **ENGINE_KW)
    assert isinstance(dense.params["layers"]["wq"], pq.QTensor4)
    assert isinstance(dense.params["lm_head"], pq.QTensor)
    gen = GenerationConfig(max_new_tokens=12, ignore_eos=True)
    prompt = dense.tokenizer.encode("int4 paged serving probe", add_bos=True)
    want = dense.generate(prompt, gen).token_ids
    assert len(want) == 12
    paged = InferenceEngine.from_config("tiny", params=dense.params, paged=True,
                                        batch_size=2, page_size=16, **ENGINE_KW)
    try:
        with cf.ThreadPoolExecutor(2) as ex:
            outs = list(ex.map(lambda _: list(paged.scheduler.stream(prompt, gen)), range(2)))
    finally:
        paged.close()
    assert outs[0] == outs[1] == want


def test_engine_quantize_modes():
    """int8 and int4 engines build with their leaves; int4_lm_head and
    quant_embed reach the tree; param_bytes shrinks with the mode; a mode
    that does not exist raises."""
    sizes = {}
    for mode in (None, "int8", "int4"):
        eng = InferenceEngine.from_config("tiny", quantize=mode, **ENGINE_KW)
        sizes[mode] = pq.param_bytes(eng.params)
        assert len(eng.generate([1, 2, 3], GenerationConfig(max_new_tokens=4,
                                                             ignore_eos=True)).token_ids) == 4
    assert sizes[None] > sizes["int8"] > sizes["int4"]
    eng = InferenceEngine.from_config("tiny", quantize="int4", int4_lm_head=True,
                                      quant_embed=True, **ENGINE_KW)
    assert isinstance(eng.params["lm_head"], pq.QTensor4)
    assert isinstance(eng.params["embed"], pq.QTensor)
    with pytest.raises(EngineError, match="unsupported quantize mode"):
        InferenceEngine.from_config("tiny", quantize="int3", **ENGINE_KW)
