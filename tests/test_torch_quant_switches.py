"""The JAX package's two quantization switches, read by the port where the
reference reads them: ``FEI_TPU_INT4_LM_HEAD`` (the LM head in int4 under
``quantize="int4"``; fei_tpu/ops/quant.py::_int4_ok) and
``FEI_TPU_QUANT_EMBED`` (an int8 embedding table with per-row scales under
either mode; fei_tpu/models/llama.py::init_params,
fei_tpu/engine/weights.py::load_checkpoint).

For every setting of the two variables, under int8 and int4, on ``tiny``
(h = 64: every contraction too short for int4) and on ``tiny`` at h = 256,
I = 512 (untied; every linear int4-eligible):
- the port's ``init_params`` and ``load_checkpoint`` give the reference's
  leaf types and ``param_bytes``;
- the reference's tree, converted with ``params_from_jax``, gives the
  reference's logits through the port's forward, and so does the port's
  own load of a local HF directory (bytes bit-equal): within 1e-4 wherever
  no int4 leaf runs. Where one does, both packages round the linear's
  input to bf16 (the kernel's contract), and an fp32 sum-order difference
  upstream moves some inputs across a bf16 rounding boundary (a few per
  forward at these sizes: 7.5e-3 was read at h = 256), so int4 logits are
  held to the repo's int4 contract, 1e-2 · max|logit|
  (tests/test_torch_quant_model.py);
- ``InferenceEngine.from_config`` and ``TorchLocalProvider`` pick the
  variables up with no argument passed, and an explicit argument wins.
All in fp32 on the CPU.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.weights import load_checkpoint as jax_load
from fei_tpu.models import llama as jl
from fei_tpu.models.configs import get_model_config as jax_cfg
from fei_tpu.ops import quant as jq
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.engine.weights import load_checkpoint
from fei_tpu_torch.models import llama as tl
from fei_tpu_torch.models.configs import MODEL_CONFIGS, get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ops import quant as pq

transformers = pytest.importorskip("transformers")

MODELS = {"tiny": {}, "tiny-h256": dict(hidden_size=256, intermediate_size=512)}
# (FEI_TPU_INT4_LM_HEAD, FEI_TPU_QUANT_EMBED)
SETTINGS = [("0", "0"), ("1", "0"), ("0", "1"), ("1", "1")]
CASES = [(m, mode, s) for m in MODELS for mode in ("int8", "int4") for s in SETTINGS]
IDS = [f"{m}-{mode}-head{h}-embed{e}" for m, mode, (h, e) in CASES]
TOL = 1e-4  # fp32 logits with no int4 leaf on the path
INT4_TOL = 1e-2  # times max|logit|: the int4 contract (module docstring)


def _env(monkeypatch, setting):
    head, embed = setting
    monkeypatch.setenv("FEI_TPU_INT4_LM_HEAD", head)
    monkeypatch.setenv("FEI_TPU_QUANT_EMBED", embed)


def _kinds(tree) -> dict:
    """Leaf path -> type name, the two packages' names made comparable."""
    out = {}
    for key, leaf in {**{f"layers/{k}": v for k, v in tree["layers"].items()},
                      **{k: v for k, v in tree.items() if k != "layers"}}.items():
        out[key] = type(leaf).__name__.replace("ArrayImpl", "Tensor").replace(
            "ndarray", "Tensor")
    return out


def _expected(model, mode, setting) -> dict:
    """What the switches must do to the leaves the test pins by name."""
    head, embed = setting
    int4 = mode == "int4" and model == "tiny-h256"
    return {"layers/wq": "QTensor4" if int4 else "QTensor",
            "lm_head": "QTensor4" if int4 and head == "1" else "QTensor",
            "embed": "QTensor" if embed == "1" else "Tensor"}


def _logits_close(params, cfg, jparams, jcfg):
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(toks),
                         jl.KVCache.create(jcfg, 2, 16, jnp.float32))
    got, _ = tl.forward(params, cfg, torch.from_numpy(toks),
                        tl.KVCache.create(cfg, 2, 16, torch.float32))
    want = np.asarray(want)
    int4 = any(isinstance(v, pq.QTensor4)
               for v in (*params["layers"].values(), *params.values()))
    atol = INT4_TOL * np.abs(want).max() if int4 else TOL
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("model,mode,setting", CASES, ids=IDS)
def test_init_params_follows_the_variables(model, mode, setting, monkeypatch):
    """``init_params`` with no switch passed: the reference's leaf types and
    bytes; the reference's tree runs through the port's forward."""
    _env(monkeypatch, setting)
    over = MODELS[model]
    jcfg, cfg = jax_cfg("tiny", **over), get_model_config("tiny", **over)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32, quantize=mode)
    params = tl.init_params(cfg, seed=0, dtype=torch.float32, quantize=mode)
    kinds = _kinds(params)
    assert kinds == _kinds(jparams)
    assert {k: kinds[k] for k in ("layers/wq", "lm_head", "embed")} == _expected(
        model, mode, setting)
    assert pq.param_bytes(params) == jq.param_bytes(jparams)
    if (model, mode, setting) == ("tiny-h256", "int4", ("1", "1")):
        # the count the reference gives in bf16 (norms in bf16)
        jb = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16, quantize=mode)
        pb = tl.init_params(cfg, seed=0, dtype=torch.bfloat16, quantize=mode)
        assert pq.param_bytes(pb) == jq.param_bytes(jb) == 832000
    _logits_close(params_from_jax(jax.tree.map(np.asarray, jparams)), cfg, jparams, jcfg)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One local HF Llama directory per model (``save_pretrained``)."""
    out = {}
    for model, over in MODELS.items():
        cfg = get_model_config("tiny", **over)
        path = tmp_path_factory.mktemp(f"hf_{model}")
        hf = transformers.LlamaConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
            max_position_embeddings=128, rope_theta=cfg.rope_theta,
            rms_norm_eps=cfg.rms_norm_eps, tie_word_embeddings=False)
        torch.manual_seed(0)
        transformers.LlamaForCausalLM(hf).eval().save_pretrained(str(path),
                                                                 safe_serialization=True)
        out[model] = str(path)
    return out


@pytest.mark.parametrize("model,mode,setting", CASES, ids=IDS)
def test_load_checkpoint_follows_the_variables(hf_dirs, model, mode, setting, monkeypatch):
    """``load_checkpoint`` of a local HF directory with no switch passed:
    the reference loader's leaf types, bytes bit-equal, the same
    ``param_bytes``, and its logits (within 1e-4 where no int4 leaf runs)."""
    _env(monkeypatch, setting)
    jcfg, jparams = jax_load(hf_dirs[model], jax_cfg("tiny"), dtype=jnp.float32,
                             quantize=mode)
    cfg, params = load_checkpoint(hf_dirs[model], get_model_config("tiny"),
                                  dtype=torch.float32, quantize=mode)
    kinds = _kinds(params)
    assert kinds == _kinds(jparams)
    assert {k: kinds[k] for k in ("layers/wq", "lm_head", "embed")} == _expected(
        model, mode, setting)
    assert pq.param_bytes(params) == jq.param_bytes(jparams)
    for key in ("lm_head", "embed"):
        leaf, want = params[key], jparams[key]
        if isinstance(leaf, tuple):
            np.testing.assert_array_equal(leaf[0].numpy(), np.asarray(want[0]), err_msg=key)
            np.testing.assert_allclose(leaf.s.numpy(), np.asarray(want.s), rtol=1e-6, atol=0)
    _logits_close(params, cfg, jparams, jcfg)


def _with_preset(monkeypatch):
    """``tiny-h256`` as a named preset, so the provider's configuration can
    name a model whose linears are all int4-eligible."""
    cfg = replace(get_model_config("tiny", **MODELS["tiny-h256"]), name="tiny-h256")
    monkeypatch.setitem(MODEL_CONFIGS, "tiny-h256", cfg)


def test_engine_and_provider_read_the_variables(monkeypatch):
    """``from_config`` and ``TorchLocalProvider`` (what ``fei serve``
    builds) pass no switch: the variables decide; an explicit argument
    still wins."""
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.utils.config import reset_config

    _with_preset(monkeypatch)
    kw = dict(device="cpu", dtype=torch.float32, max_seq_len=64, quantize="int4")
    _env(monkeypatch, ("1", "1"))
    eng = InferenceEngine.from_config("tiny-h256", **kw)
    assert isinstance(eng.params["lm_head"], pq.QTensor4)
    assert isinstance(eng.params["embed"], pq.QTensor)
    eng = InferenceEngine.from_config("tiny-h256", int4_lm_head=False, quant_embed=False, **kw)
    assert isinstance(eng.params["lm_head"], pq.QTensor)
    assert isinstance(eng.params["embed"], torch.Tensor)
    _env(monkeypatch, ("0", "0"))
    eng = InferenceEngine.from_config("tiny-h256", int4_lm_head=True, quant_embed=True, **kw)
    assert isinstance(eng.params["lm_head"], pq.QTensor4)
    assert isinstance(eng.params["embed"], pq.QTensor)

    for setting, head, embed in ((("1", "1"), pq.QTensor4, pq.QTensor),
                                 (("0", "0"), pq.QTensor, torch.Tensor)):
        _env(monkeypatch, setting)
        monkeypatch.setenv("FEI_TPU_TORCH_LOCAL_MODEL", "tiny-h256")
        monkeypatch.setenv("FEI_TPU_TORCH_LOCAL_QUANTIZE", "int4")
        monkeypatch.setenv("FEI_TPU_TORCH_LOCAL_MAX_SEQ_LEN", "64")
        reset_config()
        try:
            provider = TorchLocalProvider(device="cpu")
        finally:
            reset_config()
        params = provider.engine.params
        assert isinstance(params["layers"]["wq"], pq.QTensor4)
        assert isinstance(params["lm_head"], head)
        assert isinstance(params["embed"], embed)
