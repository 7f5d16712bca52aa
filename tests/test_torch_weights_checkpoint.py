"""The engine-native weight checkpoint: ``fei_tpu_torch.engine.weights``
``save_checkpoint(params, path)`` / ``restore_checkpoint(path)``, the
counterpart of fei_tpu/engine/weights.py's pair (tests/test_int4.py::
test_checkpoint_roundtrip_preserves_qtensor4). The reference writes with
orbax and rebuilds quantized leaves by their layout; the port writes
safetensors with a meta file naming them, restores ``QTensor`` and
``QTensor4`` leaves as those types with bitwise-equal bytes, and refuses
a quantized leaf of any other layout. A JAX tree converted with
``params_from_jax`` and round-tripped gives bitwise the logits it gave
before, and the reference's (within 1e-4 for int8; int4 under the int4
contract of tests/test_torch_quant_model.py, 1e-2 · max|logit|).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.models import llama as jl
from fei_tpu.models.configs import get_model_config as jax_cfg
from fei_tpu_torch.engine.weights import restore_checkpoint, save_checkpoint
from fei_tpu_torch.models import llama as tl
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ops.quant import QTensor, QTensor4, quantize, quantize4
from fei_tpu_torch.utils.errors import CheckpointError, EngineError

WIDE = dict(hidden_size=256, intermediate_size=512)


def _stacked4(w: torch.Tensor) -> QTensor4:
    """A stacked [L, K/2, N] ``QTensor4``, one layer quantized at a time."""
    per = [quantize4(layer) for layer in w]
    return QTensor4(torch.stack([q.p for q in per]), torch.stack([q.s for q in per]))


def _tree():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(2, 512, 128, generator=g) * 0.05
    return {"layers": {"wq": _stacked4(w), "wo": quantize(w), "attn_norm": torch.ones(2, 512)},
            "embed": torch.randn(64, 512, generator=g).bfloat16(),
            "lm_head": quantize4(w[0])}


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip_is_bitwise_and_keeps_the_types(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    save_checkpoint(tree, path)
    back = restore_checkpoint(path, device="cpu")
    assert list(back) == list(tree) and list(back["layers"]) == list(tree["layers"])
    assert type(back["layers"]["wq"]) is QTensor4 and type(back["lm_head"]) is QTensor4
    assert type(back["layers"]["wo"]) is QTensor
    for key in ("wq", "wo"):
        for f in type(tree["layers"][key])._fields:
            assert _same(getattr(back["layers"][key], f), getattr(tree["layers"][key], f))
    assert _same(back["layers"]["attn_norm"], tree["layers"]["attn_norm"])
    assert _same(back["embed"], tree["embed"])
    # saving again over the directory replaces it
    tree["layers"]["attn_norm"] = torch.zeros(2, 512)
    save_checkpoint(tree, path)
    assert not restore_checkpoint(path, device="cpu")["layers"]["attn_norm"].any()
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_layer_views_are_saved_as_their_own_tensors(tmp_path):
    """A tree of views (a deeper tree's first layers) saves and restores."""
    tree = _tree()
    cut = {"layers": {k: type(v)(*(f[:1] for f in v)) if isinstance(v, tuple) else v[:1]
                      for k, v in tree["layers"].items()}}
    save_checkpoint(cut, str(tmp_path / "c"))
    back = restore_checkpoint(str(tmp_path / "c"), device="cpu")
    assert _same(back["layers"]["wq"].p, tree["layers"]["wq"].p[:1])


def test_look_alike_layouts_are_refused(tmp_path):
    q = torch.zeros(4, 8, dtype=torch.int8)
    for bad in (QTensor(q, torch.ones(4, 3)),                       # scale not collapsed
                QTensor(q.float(), torch.ones(1, 8)),               # values not int8
                QTensor4(q, torch.ones(3, 8)),                      # groups do not divide K
                QTensor4(q, torch.ones(4, 8, dtype=torch.float16))):  # scales not fp32
        with pytest.raises(CheckpointError, match="is not that layout"):
            save_checkpoint({"layers": {"wq": bad}}, str(tmp_path / "x"))
        assert not os.path.exists(tmp_path / "x")
    with pytest.raises(CheckpointError, match="not a parameter leaf"):
        save_checkpoint({"w": [torch.ones(2)]}, str(tmp_path / "x"))

    # a plain dict that happens to hold an int8 'q' beside its 's' stays a dict
    plain = {"layers": {"wq": {"q": q, "s": torch.ones(1, 8)}}}
    save_checkpoint(plain, str(tmp_path / "p"))
    back = restore_checkpoint(str(tmp_path / "p"), device="cpu")
    assert type(back["layers"]["wq"]) is dict and _same(back["layers"]["wq"]["q"], q)

    # a meta file that claims a quantized leaf the tensors do not make
    lie = {"layers": {"wq": {"q": q, "s": torch.ones(4, 3)}}}
    save_checkpoint(lie, str(tmp_path / "l"))
    meta = tmp_path / "l" / "meta.json"
    doc = json.loads(meta.read_text())
    doc["types"] = {"layers/wq": "QTensor"}
    meta.write_text(json.dumps(doc))
    with pytest.raises(CheckpointError, match="is not that layout"):
        restore_checkpoint(str(tmp_path / "l"), device="cpu")
    doc["types"] = {"layers/wq": "QTensor4"}
    meta.write_text(json.dumps(doc))
    with pytest.raises(CheckpointError, match="recorded as QTensor4"):
        restore_checkpoint(str(tmp_path / "l"), device="cpu")
    with pytest.raises(CheckpointError, match="no parameter checkpoint"):
        restore_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    save_checkpoint({"w": torch.ones(2)}, str(tmp_path / "c"))
    if torch.cuda.is_available():
        assert restore_checkpoint(str(tmp_path / "c"))["w"].is_cuda
    else:
        with pytest.raises(EngineError, match="CUDA is not available"):
            restore_checkpoint(str(tmp_path / "c"))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_converted_jax_tree_roundtrips_to_the_reference_logits(tmp_path, mode, monkeypatch):
    """The reference's quantized tree (int4 LM head and int8 embedding
    switched on) through ``params_from_jax``, saved and restored: the same
    leaves bitwise, bitwise the same logits, the reference's logits."""
    monkeypatch.setenv("FEI_TPU_INT4_LM_HEAD", "1")
    monkeypatch.setenv("FEI_TPU_QUANT_EMBED", "1")
    jcfg, cfg = jax_cfg("tiny", **WIDE), get_model_config("tiny", **WIDE)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32, quantize=mode)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert type(params["embed"]) is QTensor
    assert type(params["lm_head"]) is (QTensor4 if mode == "int4" else QTensor)
    save_checkpoint(params, str(tmp_path / "ckpt"))
    back = restore_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert type(back["lm_head"]) is type(params["lm_head"])
    assert type(back["embed"]) is QTensor

    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)

    def logits(p):
        return tl.forward(p, cfg, torch.from_numpy(toks),
                          tl.KVCache.create(cfg, 2, 16, torch.float32))[0]

    got = logits(back)
    assert torch.equal(got, logits(params))
    want = np.asarray(jl.forward(jparams, jcfg, jnp.asarray(toks),
                                 jl.KVCache.create(jcfg, 2, 16, jnp.float32))[0])
    atol = 1e-2 * np.abs(want).max() if mode == "int4" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
