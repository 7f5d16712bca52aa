"""The port's sharding tables (fei_tpu_torch/parallel/sharding.py) against
fei_tpu's: every leaf of the tiny dense, tiny-moe, int8 and int4 trees gets
the reference's PartitionSpec under both weight profiles (int8 scales and
int4 planes following their weight), the KV cache and page pool specs are
the reference's, a rank's slices put back together give the whole tensor,
and ``restore_checkpoint(shardings=)`` restores each rank's slice bitwise.
No ranks run here: an unbound ``Mesh`` has a rank's coordinates."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.models.configs import get_model_config as jax_config
from fei_tpu.models.llama import init_params as jax_init
from fei_tpu.parallel import sharding as jsh
from fei_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fei_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.llama import KVCache, init_params
from fei_tpu_torch.ops.quant import QTensor, QTensor4
from fei_tpu_torch.parallel import sharding as psh
from fei_tpu_torch.parallel.mesh import Mesh

Q4 = dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4)
TREES = {
    "tiny": ("tiny", {}, None),
    "tiny-moe": ("tiny-moe", {}, None),
    "tiny-bias": ("tiny-bias", {}, None),
    "int8": ("tiny", {}, "int8"),
    "int4": ("tiny", Q4, "int4"),
}


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _trees(tree: str):
    """(JAX params, port params, port config) of a tree, made once per
    module: both profiles read the same trees."""
    name, over, quant = TREES[tree]
    # int4 engines on a tp mesh keep the row-parallel linears int8
    excl = frozenset({"wo", "w_down"}) if quant == "int4" else frozenset()
    jparams = jax_init(jax_config(name, **over), jax.random.PRNGKey(0), dtype=jnp.float32,
                       quantize=quant, int4_exclude=excl)
    cfg = get_model_config(name, **over)
    params = init_params(cfg, seed=0, dtype=torch.float32, quantize=quant, int4_exclude=excl)
    return jparams, params, cfg


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"tp": 2}, devices=jax.devices()[:2])


@pytest.mark.parametrize("profile", ["sharded", "replicated"])
@pytest.mark.parametrize("tree", list(TREES))
def test_every_leaf_placement_matches_reference(tree, profile, jax_mesh):
    jparams, params, cfg = _trees(tree)
    quant = TREES[tree][2]
    jrules = jsh.REPLICATED_RULES if profile == "replicated" else None
    want = dict(_leaves(jsh.param_shardings(jparams, jax_mesh, cfg.is_moe, rules=jrules)))
    got = dict(_leaves(psh.param_shardings(params, Mesh({"tp": 2}), cfg.is_moe,
                                           rules=psh.rules_for(profile, cfg.is_moe))))
    assert set(got) == set(want)
    kinds = set()
    for path, sh in got.items():
        w = want[path]
        leaf = dict(_leaves(params))[path]
        if isinstance(leaf, (QTensor, QTensor4)):
            kinds.add(type(leaf).__name__)
            for field, s_got, s_want, t in zip(leaf._fields, sh, w, leaf):
                assert _pad(s_got.spec, t.dim()) == _pad(s_want.spec, t.dim()), (path, field)
        else:
            kinds.add("tensor")
            assert _pad(sh.spec, leaf.dim()) == _pad(w.spec, leaf.dim()), path
    if quant == "int4":
        assert kinds == {"tensor", "QTensor", "QTensor4"}


@pytest.mark.parametrize("moe,bias,o_bias", [(False, False, False), (True, False, False),
                                            (False, True, True)])
def test_param_specs_template_matches_reference(moe, bias, o_bias):
    want = dict(_leaves(jsh.param_specs(moe, bias, o_bias)))
    got = dict(_leaves(psh.param_specs(moe, bias, o_bias)))
    assert got.keys() == want.keys()
    for path, spec in got.items():
        assert tuple(spec) == tuple(want[path]), path


def test_cache_and_pool_specs_match_reference(jax_mesh):
    jm = jax_make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    pm = Mesh({"dp": 2, "tp": 2})
    for batch in (None, 4, 3):
        want = jsh.cache_shardings(jm, batch)
        got = psh.cache_shardings(pm, batch)
        for w, g in zip(want, got):
            assert tuple(g.spec) == tuple(w.spec)
    want = jsh.paged_pool_specs()
    got = psh.paged_pool_specs()
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    assert psh.rules_for("replicated", False) == psh.REPLICATED_RULES
    with pytest.raises(ValueError, match="weights profile"):
        psh.rules_for("diagonal", False)


def test_q4_contraction_shard_refused():
    with pytest.raises(ValueError, match="contraction"):
        psh._q4_specs(psh.P(None, "tp", None), 3)
    with pytest.raises(ValueError, match="no partition rule"):
        psh.match_partition_rules((), {"embed": None})


def _merge(parts, specs):
    """Put tp-rank slices back together along their sharded dimension."""
    dims = [i for i, e in enumerate(specs) if e == "tp"]
    return torch.cat(parts, dim=dims[0]) if dims else parts[0]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_shard_params_slices_put_back_whole(quant):
    over = Q4 if quant == "int4" else {}
    cfg = get_model_config("tiny", **over)
    excl = frozenset({"wo", "w_down"}) if quant == "int4" else frozenset()
    params = init_params(cfg, seed=1, dtype=torch.float32, quantize=quant, int4_exclude=excl)
    ranks = [psh.shard_params(params, Mesh({"tp": 2}, rank=r), cfg.is_moe) for r in range(2)]
    shard = psh.param_shardings(params, Mesh({"tp": 2}), cfg.is_moe)
    flat_s = dict(_leaves(shard))
    for path, leaf in _leaves(params):
        parts = [dict(_leaves(r))[path] for r in ranks]
        if isinstance(leaf, (QTensor, QTensor4)):
            for i, t in enumerate(leaf):
                spec = _pad(flat_s[path][i].spec, t.dim())
                assert torch.equal(_merge([p[i] for p in parts], spec), t), path
        else:
            assert torch.equal(_merge(parts, _pad(flat_s[path].spec, leaf.dim())), leaf), path


def test_cache_and_pool_shards():
    cfg = get_model_config("tiny")
    m = Mesh({"dp": 2, "tp": 2}, rank=3)
    whole = (cfg.num_layers, 4, 16, cfg.num_kv_heads, cfg.head_dim_)
    assert psh.cache_shardings(m, 4).k.local_shape(whole) == (
        cfg.num_layers, 2, 16, cfg.num_kv_heads // 2, cfg.head_dim_)
    assert psh.cache_shardings(m, 1).k.local_shape(whole[:1] + (1,) + whole[2:])[1] == 1
    pool = PagedKVCache.create(cfg, 6, 2, 4, page_size=4, dtype=torch.float32)
    pool.k_pages.copy_(torch.randn(pool.k_pages.shape))
    mine = psh.shard_paged_pool(pool, m)
    assert torch.equal(mine.k_pages, pool.k_pages[:, :, 1:2])
    assert mine.block_table is pool.block_table and mine.k_scales is None
    cache = KVCache.create(cfg, 1, 8, torch.float32)
    assert psh.cache_shardings(m, 1).length.shard(cache.length) is cache.length


def test_sharded_restore_lands_bitwise(tmp_path):
    """Each rank restores its Megatron slices of a saved tree (reading only
    those bytes); the slices put back together are the saved tensors."""
    cfg = get_model_config("tiny", **Q4)
    excl = frozenset({"wo", "w_down"})
    params = init_params(cfg, seed=2, dtype=torch.float32, quantize="int4", int4_exclude=excl)
    save_checkpoint(str(tmp_path), 0, params)
    parts = []
    for r in range(2):
        sh = psh.param_shardings(params, Mesh({"tp": 2}, rank=r), cfg.is_moe)
        parts.append(restore_checkpoint(str(tmp_path), shardings={"params": sh},
                                        device="cpu")["params"])
    assert parts[0]["layers"]["wq"].p.shape[-1] == params["layers"]["wq"].p.shape[-1] // 2
    flat_s = dict(_leaves(psh.param_shardings(params, Mesh({"tp": 2}), cfg.is_moe)))
    for path, leaf in _leaves(params):
        got = [dict(_leaves(p))[path] for p in parts]
        fields = list(zip(*got)) if isinstance(leaf, tuple) else [got]
        whole = list(leaf) if isinstance(leaf, tuple) else [leaf]
        specs = list(flat_s[path]) if isinstance(leaf, tuple) else [flat_s[path]]
        for f_parts, t, s in zip(fields, whole, specs):
            assert torch.equal(_merge(list(f_parts), _pad(s.spec, t.dim())), t), path
