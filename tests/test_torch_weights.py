"""The port's checkpoint loader against fei_tpu's on the same files: a tiny
HF LlamaForCausalLM (GQA; untied, tied, and with attention biases)
written with save_pretrained, loaded by both packages, forward logits
compared in fp32 (atol 1e-4: summation order through three layers)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from fei_tpu.engine.weights import load_checkpoint as jax_load  # noqa: E402
from fei_tpu.models.configs import get_model_config  # noqa: E402
from fei_tpu.models.llama import KVCache as JaxCache  # noqa: E402
from fei_tpu.models.llama import forward as jax_forward  # noqa: E402
from fei_tpu_torch.engine.weights import load_checkpoint  # noqa: E402
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config  # noqa: E402
from fei_tpu_torch.models.llama import KVCache, forward  # noqa: E402
from fei_tpu_torch.utils.errors import CheckpointError  # noqa: E402


def _save_tiny_llama(path, tie: bool, bias: bool):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=tie, attention_bias=bias,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    if bias:  # init zeroes Linear biases; randomize so their math is checked
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    getattr(layer.self_attn, proj).bias.normal_(0, 0.5)
    model.save_pretrained(str(path), safe_serialization=True)


@pytest.mark.parametrize(
    "tie,bias", [(False, False), (True, False), (False, True)],
    ids=["untied", "tied", "attention_bias"],
)
def test_load_checkpoint_logits_match_jax(tmp_path, tie, bias):
    _save_tiny_llama(tmp_path, tie, bias)
    ids = np.array([[1, 7, 42, 99, 3, 250, 17, 5]], dtype=np.int32)

    jcfg, jparams = jax_load(str(tmp_path), get_model_config("tiny"), dtype=jnp.float32)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(ids),
                          JaxCache.create(jcfg, 1, 16, jnp.float32))

    cfg, params = load_checkpoint(str(tmp_path), pt_get_model_config("tiny"),
                                  dtype=torch.float32)
    assert vars(cfg) == vars(jcfg)
    assert set(params["layers"]) == set(jparams["layers"])
    got, _ = forward(params, cfg, torch.from_numpy(ids),
                     KVCache.create(cfg, 1, 16, torch.float32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=1e-4, rtol=0)


def test_wrong_config_shape_raises(tmp_path):
    _save_tiny_llama(tmp_path, False, False)
    cfg_path = tmp_path / "config.json"
    cfg_path.unlink()  # the preset's shapes then disagree with the tensors
    with pytest.raises(CheckpointError, match="shape"):
        load_checkpoint(str(tmp_path), pt_get_model_config("debug"), dtype=torch.float32)
