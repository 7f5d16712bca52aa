"""Sharding rules: where each leaf of the stacked Llama/Mixtral param dict
and the KV caches live on a mesh (counterpart of
fei_tpu/parallel/sharding.py).

The rule tables are the reference's, entry for entry: an ordered
``(regex, P)`` sequence matched against each leaf's '/'-joined path,
first match wins. A ``P`` is a PartitionSpec's tuple of per-dimension
entries: a mesh axis name shards that dimension over the axis, None keeps
it whole. Where GSPMD reads a spec as a layout and inserts collectives,
the port reads it as the slice each rank holds (``Sharding.shard``), and
the forward (models/llama.py) issues the collectives itself.

Layout (Megatron-style column/row split: one all_reduce per sublayer):

  wq/wk/wv  [L, H, heads*D]  -> split output (head) dim over tp   (column)
  wo        [L, heads*D, H]  -> split input  (head) dim over tp   (row)
  w_gate/up [L, H, I]        -> split I over tp                   (column)
  w_down    [L, I, H]        -> split I over tp                   (row)
  embed     [V, H]           -> split vocab over tp
  experts   [L, E, ...]      -> E over ep, then I over tp
  KV cache  [L, B, S, K, D]  -> B over dp, K (kv heads) over tp

``REPLICATED_RULES`` is the bit-exact serving profile (the
``FEI_TPU_MESH`` default): every weight whole on every rank, so every
matmul keeps the one-device contraction order and only the attention
kernels (kv heads over tp, rows over dp) and the page pool shard.
"""

from __future__ import annotations

import re

import torch


class P(tuple):
    """A PartitionSpec: one entry per leading dimension (an axis name or
    None); missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class Sharding:
    """A spec on a mesh (the reference's NamedSharding): ``shard(t)`` is
    this rank's slice of the whole tensor ``t``."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"

    def slices(self, shape) -> tuple[slice, ...]:
        """Per-dimension slice of this rank's shard of a ``shape`` tensor."""
        out = []
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        for dim, (size, ax) in enumerate(zip(shape, entries)):
            if ax is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[ax]
            if size % n:
                raise ValueError(
                    f"dimension {dim} ({size}) of a {tuple(shape)} leaf does not "
                    f"divide over {ax}={n} (spec {self.spec!r})")
            step = size // n
            c = self.mesh.coords[ax]
            out.append(slice(c * step, (c + 1) * step))
        return tuple(out)

    def local_shape(self, shape) -> tuple[int, ...]:
        return tuple(len(range(*s.indices(n))) for s, n in zip(self.slices(shape), shape))

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice as a tensor of its own (a whole leaf is
        returned as is)."""
        sl = self.slices(t.shape)
        if all(s == slice(None) for s in sl):
            return t
        return t[sl].contiguous().clone()


# -- declarative per-family sharding rules ------------------------------------

DENSE_RULES: tuple[tuple[str, P], ...] = (
    # embed [V, H]: vocab over tp (each rank owns a vocab slice)
    (r"embed$", P("tp", None)),
    # attention column split: output (head) dim over tp
    (r"layers/(wq|wk|wv)$", P(None, None, "tp")),
    # qkv biases follow their projection's column (head-dim) split;
    # b_gate is Phi fc1's bias, same column contract
    (r"layers/(bq|bk|bv|b_gate)$", P(None, "tp")),
    # wo row split: input (head) dim over tp — one all_reduce per block
    (r"layers/wo$", P(None, "tp", None)),
    # MLP column/row split over the intermediate dim
    (r"layers/(w_gate|w_up)$", P(None, None, "tp")),
    (r"layers/w_down$", P(None, "tp", None)),
    (r"lm_head$", P(None, "tp")),
    (r"lm_head_b$", P("tp")),  # follows the head's vocab split
    # everything else replicates: norms and their biases, b_down/bo (the
    # bias of a reduced row-parallel output adds once), router
    (r".*", P()),
)

MOE_RULES: tuple[tuple[str, P], ...] = (
    (r"layers/router$", P()),
    # experts [L, E, ...]: E over ep, then the intermediate dim over tp
    (r"layers/(w_gate|w_up)$", P(None, "ep", None, "tp")),
    (r"layers/w_down$", P(None, "ep", "tp", None)),
) + DENSE_RULES

REPLICATED_RULES: tuple[tuple[str, P], ...] = (
    (r".*", P()),
)

WEIGHT_PROFILES = ("replicated", "sharded")


def partition_rules(is_moe: bool) -> tuple[tuple[str, P], ...]:
    """The rule table for a model family."""
    return MOE_RULES if is_moe else DENSE_RULES


def rules_for(weights: str, is_moe: bool):
    """The table of a weights profile: "sharded" (Megatron) or
    "replicated" (the bit-exact serving profile)."""
    if weights not in WEIGHT_PROFILES:
        raise ValueError(
            f"unknown weights profile {weights!r} (expected 'sharded' or 'replicated')")
    return REPLICATED_RULES if weights == "replicated" else partition_rules(is_moe)


def match_partition_rules(rules, tree: dict) -> dict:
    """Map a param dict to a congruent spec dict by matching each leaf's
    '/'-joined path against ``rules`` (first match wins). Quantized leaves
    (QTensor/QTensor4) are leaves here; their fields' specs derive from the
    weight's spec (``_scale_spec``, ``_q4_specs``). A path no rule covers
    raises: a silently replicated 10-GB tensor is the bug this guards."""

    def spec_for(path: str) -> P:
        for rx, spec in rules:
            if re.search(rx, path):
                return spec
        raise ValueError(f"no partition rule matches param {path!r}")

    def walk(prefix: str, sub):
        if isinstance(sub, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else k, v) for k, v in sub.items()}
        return spec_for(prefix)

    return walk("", tree)


def param_specs(is_moe: bool, attn_bias: bool = False, o_bias: bool = False) -> dict:
    """Spec dict matching models/llama.py's param layout; the key template
    only controls WHICH leaves exist, every spec comes from the family
    table."""
    layers = dict.fromkeys([
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
        "attn_norm_b", "mlp_norm_b", "b_gate", "b_down",
        "w_gate", "w_up", "w_down",
    ])
    if attn_bias:
        layers.update(dict.fromkeys(["bq", "bk", "bv"]))
    if o_bias:
        layers["bo"] = None
    if is_moe:
        layers["router"] = None
    template = {
        "embed": None,
        "layers": layers,
        "final_norm": None,
        "final_norm_b": None,
        "lm_head": None,
        "lm_head_b": None,
    }
    return match_partition_rules(partition_rules(is_moe), template)


def _scale_spec(spec: P, s_shape: tuple) -> P:
    """Spec for a QTensor scale: the weight's spec with axis entries dropped
    where the scale's dim collapsed to 1 (the contraction axis)."""
    entries = list(spec) + [None] * (len(s_shape) - len(spec))
    return P(*[None if s_shape[i] == 1 else entries[i] for i in range(len(s_shape))])


def _q4_specs(spec: P, rank: int) -> tuple[P, P]:
    """(packed, scale) specs for a QTensor4 from its weight spec. The
    contraction axis (-2: packed nibble rows / scale groups) must not be
    sharded — nibble pairs span it."""
    entries = list(spec) + [None] * (rank - len(spec))
    if entries[-2] is not None:
        raise ValueError(
            f"QTensor4 cannot shard its contraction axis (spec {spec}); "
            "int4 eligibility must keep contraction-sharded weights int8"
        )
    return P(*entries), P(*entries)


def _tree_shardings(specs: dict, params: dict, mesh) -> dict:
    """Match the spec tree to the actual param tree: int8 ``QTensor``
    leaves get the weight's spec on ``q`` and a contraction-collapsed spec
    on ``s``; ``QTensor4`` leaves shard packed bytes and grouped scales
    alike (out-channel axis only)."""
    from fei_tpu_torch.ops.quant import QTensor, QTensor4

    def pick(spec_subtree, param_subtree):
        if isinstance(param_subtree, dict):
            return {k: pick(spec_subtree[k], v) for k, v in param_subtree.items()}
        if isinstance(param_subtree, QTensor):
            return QTensor(
                q=Sharding(mesh, spec_subtree),
                s=Sharding(mesh, _scale_spec(spec_subtree, tuple(param_subtree.s.shape))),
            )
        if isinstance(param_subtree, QTensor4):
            p_spec, s_spec = _q4_specs(spec_subtree, param_subtree.p.dim())
            return QTensor4(p=Sharding(mesh, p_spec), s=Sharding(mesh, s_spec))
        return Sharding(mesh, spec_subtree)

    return pick(specs, params)


def param_shardings(params: dict, mesh, is_moe: bool, rules=None) -> dict:
    """Sharding tree for an actual param dict (absent leaves, e.g. a tied
    lm_head, need no bookkeeping). ``rules`` overrides the family table."""
    if rules is None:
        rules = partition_rules(is_moe)
    return _tree_shardings(match_partition_rules(rules, params), params, mesh)


def param_shardings_from_cfg(cfg, mesh) -> dict:
    """Sharding tree from the model config alone (no params needed): what
    engine/weights.load_checkpoint slices each tensor by as it reads."""
    specs = param_specs(cfg.is_moe, getattr(cfg, "attn_bias", False),
                        getattr(cfg, "o_bias", False))
    if cfg.tie_embeddings:
        specs.pop("lm_head", None)

    def to_sharding(tree):
        if isinstance(tree, dict):
            return {k: to_sharding(v) for k, v in tree.items()}
        return Sharding(mesh, tree)

    return to_sharding(specs)


def cache_shardings(mesh, batch: int | None = None):
    """Dense KV-cache shardings. The batch dim shards over dp only when the
    actual batch divides the dp axis — a batch-1 cache on a dp>1 mesh
    replicates over dp instead of erroring."""
    from fei_tpu_torch.models.llama import KVCache

    dp = mesh.shape.get("dp", 1)
    batch_axis = "dp" if (batch is None or batch % dp == 0) else None
    return KVCache(
        k=Sharding(mesh, P(None, batch_axis, None, "tp", None)),
        v=Sharding(mesh, P(None, batch_axis, None, "tp", None)),
        length=Sharding(mesh, P(batch_axis)),
    )


def paged_pool_specs() -> dict:
    """Specs of the paged KV pool fields: pages [L, P, K, ps, D] shard kv
    heads over tp; block tables and lengths replicate (rank 0 sends them
    with every dispatch) and the kernel wrappers slice their batch rows
    over dp, so dp groups each attend their own slot slice."""
    page = P(None, None, "tp", None, None)
    rep = P()
    return {
        "k_pages": page, "v_pages": page,
        "k_scales": page, "v_scales": page,
        "block_table": rep, "lengths": rep,
    }


def shard_paged_pool(pool, mesh):
    """This rank's shard of a whole PagedKVCache per ``paged_pool_specs``
    (None fields — a non-int8 pool's scales — pass through)."""
    specs = paged_pool_specs()

    def put(name, t):
        return None if t is None else Sharding(mesh, specs[name]).shard(t)

    return pool._replace(**{name: put(name, getattr(pool, name)) for name in specs})


def shard_params(params: dict, mesh, is_moe: bool, rules=None) -> dict:
    """This rank's slice of every leaf of a whole param dict (quantized
    leaves field by field). An axis that does not divide a dimension
    raises."""
    from fei_tpu_torch.ops.quant import QTensor, QTensor4

    shardings = param_shardings(params, mesh, is_moe, rules=rules)

    def put(sh, leaf):
        if isinstance(leaf, dict):
            return {k: put(sh[k], v) for k, v in leaf.items()}
        if isinstance(leaf, (QTensor, QTensor4)):
            return type(leaf)(*(s.shard(f) for s, f in zip(sh, leaf)))
        return sh.shard(leaf)

    return put(shardings, params)


def shard_engine(engine, mesh, weights: str = "sharded") -> None:
    """Re-home an InferenceEngine's weights onto a mesh in place: this
    rank keeps its slice of each leaf under the ``weights`` profile's table
    ("sharded": the Megatron tables, not bit-identical to one device, the
    all_reduces reorder summation; "replicated": every weight whole, the
    ``FEI_TPU_MESH`` serving default, token-identical to one device)."""
    rules = rules_for(weights, engine.cfg.is_moe)
    engine.params = shard_params(engine.params, mesh, engine.cfg.is_moe, rules=rules)
    engine.mesh = mesh
    engine.mesh_weights = weights
