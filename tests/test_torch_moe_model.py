"""The port's MoE model (``tiny-moe``: 2 layers, 4 experts, top-2) against
fei_tpu's, on the CPU in fp32 with the same weights (``params_from_jax``).

- ``forward``, ``forward_paged_block`` and ``forward_paged_merged`` logits
  at atol/rtol 1e-4 (as tests/test_torch_model.py: two layers of products
  summed in other orders), with ``FEI_TPU_ROUTED_MOE`` at 0, 1 and auto
  picking the same formulation in both packages;
- ``forward_train``'s loss and gradients at 2e-5 against ``jax.grad``
  (the dense oracle in both, as the JAX training path takes);
- a tiny HF Mixtral written with ``save_pretrained``, loaded by both
  packages (bf16-free fp32, and int8 with bit-equal expert bytes), against
  each other and HF's own logits (atol 1e-4);
- greedy ``tiny-moe`` streams of the dense and the paged engine equal to
  the JAX package's;
- the train step and the model checkpoints on the MoE leaves; the
  expert-parallel branch raises naming roadmap module C4.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.paged_cache import PagedKVCache as JaxPool
from fei_tpu.engine.weights import load_checkpoint as jax_load
from fei_tpu.models import llama as jl
from fei_tpu.models.configs import get_model_config as jax_cfg
from fei_tpu_torch.engine import restore_checkpoint, save_checkpoint
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.engine.train import TrainConfig, loss_and_grads, make_train_step
from fei_tpu_torch.engine.weights import load_checkpoint
from fei_tpu_torch.models import llama as tl
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ops.quant import QTensor
from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.tree import flatten

NAME = "tiny-moe"
ATOL = 1e-4
GRAD_ATOL = 2e-5


@pytest.fixture(scope="module")
def shared():
    jcfg = jax_cfg(NAME)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams, get_model_config(NAME), params_from_jax(jax.tree.map(np.asarray, jparams))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-4)


@pytest.fixture
def routed_calls(monkeypatch):
    """Counts the port's routed MoE calls (one per layer that routes)."""
    calls = []
    real = tl.moe_mlp_routed

    def spy(*a):
        calls.append(a[0].shape[0] * a[0].shape[1])
        return real(*a)

    monkeypatch.setattr(tl, "moe_mlp_routed", spy)
    return calls


@pytest.mark.parametrize("mode,routed_moe,T,routes", [
    ("0", True, 20, False), ("1", False, 5, True), ("auto", True, 20, True),
    ("auto", False, 20, False), ("auto", True, 5, False),
])
def test_forward_logits_match_jax(shared, monkeypatch, routed_calls, mode, routed_moe, T,
                                  routes):
    """``FEI_TPU_ROUTED_MOE``: 0 the dense oracle, 1 routed everywhere,
    auto routed where the caller allows it from 16 tokens (B = 2 rows)."""
    jcfg, jparams, cfg, tparams = shared
    monkeypatch.setenv("FEI_TPU_ROUTED_MOE", mode)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(toks),
                         jl.KVCache.create(jcfg, 2, 32, jnp.float32), routed_moe=routed_moe)
    got, cache = tl.forward(tparams, cfg, torch.from_numpy(toks),
                            tl.KVCache.create(cfg, 2, 32, torch.float32), routed_moe=routed_moe)
    _close(got, want)
    assert cache.length.tolist() == [T, T]
    assert routed_calls == ([2 * T] * cfg.num_layers if routes else [])


def test_paged_block_and_merged_match_jax(shared):
    """A 20-token block per row, one decode step, then a merged dispatch
    (a 13-token chunk of row 1 in groups of 4 beside row 0's decode)."""
    jcfg, jparams, cfg, tparams = shared
    ps, width, n_pages = 16, 6, 20
    table = np.array([[4, 9, 2, 11, 0, 0], [7, 1, 13, 5, 16, 0]], np.int32)
    jpool = JaxPool.create(jcfg, n_pages, 2, width, page_size=ps, dtype=jnp.float32)
    jpool = jpool._replace(block_table=jnp.asarray(table))
    tpool = PagedKVCache.create(cfg, n_pages, 2, width, page_size=ps, dtype=torch.float32)
    tpool = tpool._replace(block_table=torch.from_numpy(table))
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
    jlog, jpool = jl.forward_paged_block(jparams, jcfg, jnp.asarray(toks), jpool)
    tlog, tpool = tl.forward_paged_block(tparams, cfg, torch.from_numpy(toks), tpool)
    _close(tlog, jlog)
    step = np.asarray(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
    jlog, jpool = jl.forward_paged(jparams, jcfg, jnp.asarray(step), jpool)
    tlog, tpool = tl.forward_paged(tparams, cfg, torch.from_numpy(step), tpool)
    _close(tlog, jlog)
    _close(tpool.k_pages, jpool.k_pages, 1e-5)
    live = table.copy()
    live[1] = 0
    lengths = np.array([21, 0], np.int32)
    jpool = jpool._replace(block_table=jnp.asarray(live), lengths=jnp.asarray(lengths))
    tpool = tpool._replace(block_table=torch.from_numpy(live), lengths=torch.from_numpy(lengths))
    chunk = rng.integers(1, cfg.vocab_size, (1, 13)).astype(np.int32)
    dec = np.array([[5], [0]], np.int32)
    jh, jlog, jpool = jl.forward_paged_merged(
        jparams, jcfg, jnp.asarray(chunk), jnp.asarray(table[1:2]),
        jnp.asarray([16], jnp.int32), jnp.asarray(dec), jpool, rows=4)
    th, tlog, tpool = tl.forward_paged_merged(
        tparams, cfg, torch.from_numpy(chunk), torch.from_numpy(table[1:2]), 16,
        torch.from_numpy(dec), tpool, rows=4)
    _close(th, jh)
    _close(tlog[:1], jlog[:1])
    _close(tpool.v_pages, jpool.v_pages, 1e-5)


def test_forward_train_loss_and_grads_match_jax(shared):
    """The MoE training forward (the dense oracle in both packages) and its
    gradients, router and stacked experts included."""
    jcfg, jparams, cfg, tparams = shared
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)

    def jax_loss(p):
        logits = jl.forward_train(p, jcfg, jnp.asarray(toks)[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(toks)[:, 1:]).mean()

    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    loss, grads = loss_and_grads(tparams, cfg, torch.from_numpy(toks), device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), atol=GRAD_ATOL, rtol=0)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = flatten(grads)
    assert set(got) == set(want) and {"layers/router", "layers/w_up"} <= set(got)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=GRAD_ATOL, rtol=0,
                                   err_msg=path)


def test_train_step_and_checkpoint_carry_the_moe_leaves(tmp_path):
    """One step moves the router and every expert, and a checkpoint of the
    MoE tree restores bitwise."""
    cfg = get_model_config(NAME)
    params = tl.init_params(cfg, seed=3, dtype=torch.float32)
    before = {k: v.clone() for k, v in flatten(params).items()}
    opt, step = make_train_step(cfg, TrainConfig(learning_rate=1e-2), device="cpu")
    state = opt.init(params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
    params, state, loss = step(params, state, toks)
    assert np.isfinite(float(loss))
    for name in ("layers/router", "layers/w_gate", "layers/w_up", "layers/w_down"):
        assert not torch.equal(flatten(params)[name], before[name]), name
    save_checkpoint(str(tmp_path), 1, params, opt_state=state)
    out = restore_checkpoint(str(tmp_path), device="cpu")
    for path, leaf in flatten({"p": params, "m": state["mu"]}).items():
        assert torch.equal(flatten({"p": out["params"], "m": out["opt_state"]["mu"]})[path],
                           leaf), path


def _tiny_hf_mixtral(path):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-5,
    )
    torch.manual_seed(2)
    model = transformers.MixtralForCausalLM(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=True)
    return model


@pytest.mark.parametrize("routed", ["0", "1"])
def test_load_checkpoint_of_a_tiny_hf_mixtral(tmp_path, monkeypatch, routed):
    monkeypatch.setenv("FEI_TPU_ROUTED_MOE", routed)
    model = _tiny_hf_mixtral(tmp_path)
    ids = np.array([[1, 11, 47, 101, 5, 252, 19, 7]], dtype=np.int32)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids).long()).logits.float().numpy()
    jcfg, jparams = jax_load(str(tmp_path), jax_cfg(NAME), dtype=jnp.float32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(ids), jl.KVCache.create(jcfg, 1, 16, jnp.float32))
    cfg, params = load_checkpoint(str(tmp_path), get_model_config(NAME), dtype=torch.float32)
    assert vars(cfg) == vars(jcfg)
    assert set(params["layers"]) == set(jparams["layers"])
    got, _ = tl.forward(params, cfg, torch.from_numpy(ids), tl.KVCache.create(cfg, 1, 16, torch.float32))
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), hf, atol=ATOL, rtol=0)


def test_int8_load_of_a_tiny_hf_mixtral_is_bit_equal(tmp_path):
    _tiny_hf_mixtral(tmp_path)
    _, jparams = jax_load(str(tmp_path), jax_cfg(NAME), dtype=jnp.float32, quantize="int8")
    _, params = load_checkpoint(str(tmp_path), get_model_config(NAME), dtype=torch.float32,
                                quantize="int8")
    for name in ("w_gate", "w_up", "w_down"):
        leaf, ref = params["layers"][name], jparams["layers"][name]
        assert isinstance(leaf, QTensor) and leaf.q.shape == ref.q.shape
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q), err_msg=name)
        np.testing.assert_array_equal(leaf.s.numpy(), np.asarray(ref.s), err_msg=name)
    np.testing.assert_array_equal(params["layers"]["router"].numpy(),
                                  np.asarray(jparams["layers"]["router"]))


def _prompt():
    return np.random.default_rng(5).integers(1, 500, 20).tolist()


def test_greedy_streams_match_jax_dense_and_paged():
    jeng = JaxEngine.from_config(NAME, dtype=jnp.float32, max_seq_len=128)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    want = jeng.generate(_prompt(), JaxGen(max_new_tokens=12, ignore_eos=True)).token_ids
    gen = GenerationConfig(max_new_tokens=12, ignore_eos=True)
    dense = InferenceEngine.from_config(NAME, params=params, device="cpu", dtype=torch.float32,
                                        max_seq_len=128)
    assert dense.generate(_prompt(), gen).token_ids == want
    jp = JaxEngine.from_config(NAME, dtype=jnp.float32, max_seq_len=128, paged=True,
                               page_size=16, batch_size=2)  # the same seed's weights
    jwant = list(jp.scheduler.stream(_prompt(), JaxGen(max_new_tokens=12, ignore_eos=True)))
    paged = InferenceEngine.from_config(NAME, params=params, device="cpu", dtype=torch.float32,
                                        max_seq_len=128, paged=True, page_size=16, batch_size=2)
    try:
        assert list(paged.scheduler.stream(_prompt(), gen)) == jwant == want
    finally:
        paged.close()
        jp.close()


def test_engine_builds_on_the_cpu_and_defaults_to_the_card():
    eng = InferenceEngine.from_config(NAME, device="cpu", dtype=torch.float32, max_seq_len=64)
    assert eng.cfg.is_moe and eng.params["layers"]["router"].shape == (2, 64, 4)
    assert len(eng.generate([1, 2, 3], GenerationConfig(max_new_tokens=4,
                                                        ignore_eos=True)).token_ids) == 4
    if not torch.cuda.is_available():
        with pytest.raises(EngineError, match="CUDA"):
            InferenceEngine.from_config(NAME)


def test_expert_parallel_raises_naming_c4(shared, monkeypatch):
    """Expert parallelism (C4) is ported: given an ep mesh, ``_moe`` takes
    the reference's branch, ``moe_mlp_ep_routed`` at
    ``FEI_TPU_EP_CAPACITY`` (default 2.0); ``FEI_TPU_ROUTED_MOE=0`` still
    takes the dense oracle, on the mesh too."""
    from fei_tpu_torch.parallel import expert as pt_expert
    from fei_tpu_torch.parallel.mesh import Mesh

    _, _, cfg, tparams = shared
    lp = tl.layer_params(tparams, 0)
    y = torch.randn((1, 4, cfg.hidden_size), generator=torch.Generator().manual_seed(3))
    seen = []
    monkeypatch.setattr(pt_expert, "moe_mlp_ep_routed",
                        lambda *a, **kw: seen.append(kw) or torch.zeros_like(a[0]))
    monkeypatch.setenv("FEI_TPU_EP_CAPACITY", "1.25")
    tl._moe(cfg, y, lp, True, moe_mesh=Mesh({"ep": 2}))
    assert seen == [dict(capacity_factor=1.25, tp_axis=None,
                         intermediate_size=cfg.intermediate_size)]
    monkeypatch.setenv("FEI_TPU_ROUTED_MOE", "0")  # the oracle needs no mesh
    got = tl._moe(cfg, y, lp, True, moe_mesh=Mesh({"ep": 2}))
    assert len(seen) == 1 and got.shape == y.shape
    _close(got, jl.moe_mlp(jnp.asarray(y.numpy()), *(jnp.asarray(lp[k].numpy()) for k in (
        "router", "w_gate", "w_up", "w_down")), cfg.num_experts_per_tok))
