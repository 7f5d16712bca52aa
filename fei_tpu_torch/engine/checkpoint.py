"""Model, optimizer and cache checkpoints, and the drain-time request
snapshots (counterpart of fei_tpu/engine/checkpoint.py).

Step-numbered directories with retention, one atomic composite save per
step: ``<directory>/<step>/params.safetensors`` and, when given,
``opt_state.safetensors`` and ``cache.safetensors``, with a ``meta.json``
beside them. Where the JAX package goes through orbax, this module writes
the tensors with ``safetensors.torch`` into a temporary directory, fsyncs
the files and the directory, and renames it into place: a crash leaves
either the whole step or none of it. NamedTuple leaves — quantized
weights (``QTensor``, ``QTensor4``) and caches (``KVCache``,
``PagedKVCache``) — are stored field by field and rebuilt on restore.

The request snapshots (``save_request_snapshots`` and its readers) are
the JAX package's v3 JSON file, byte-compatible: a file either package
writes loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from fei_tpu_torch.engine.engine import resolve_device
from fei_tpu_torch.parallel.mesh import mesh_geometry
from fei_tpu_torch.utils.errors import CheckpointError
from fei_tpu_torch.utils.fsync import fsync_dir, fsync_file
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.tree import unflatten

log = get_logger("engine.checkpoint")

_META = "meta.json"

# the geometry a snapshot without a mesh records: one device, the JAX
# package's ``mesh_geometry(None)``
SINGLE_DEVICE_MESH = mesh_geometry(None)


def _steps(directory: str) -> list[int]:
    """The complete steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, _META))
    )


def _named_types() -> dict:
    from fei_tpu_torch.engine.paged_cache import PagedKVCache
    from fei_tpu_torch.models.llama import KVCache
    from fei_tpu_torch.ops.quant import QTensor, QTensor4

    return {t.__name__: t for t in (QTensor, QTensor4, KVCache, PagedKVCache)}


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def _encode(component: str, tree: Any) -> tuple[dict, dict]:
    """``(flat tensors by path, NamedTuple type name by path)`` of a tree of
    dicts, tensors and the known NamedTuples (a None field is left out)."""
    known = _named_types()
    flat: dict = {}
    types: dict = {}

    def walk(node, path):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            name = type(node).__name__
            if name not in known:
                raise CheckpointError(f"{component}/{path}: cannot checkpoint a {name}")
            types[path] = name
            for field in node._fields:
                value = getattr(node, field)
                if value is not None:
                    walk(value, _join(path, field))
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, _join(path, str(key)))
        elif isinstance(node, torch.Tensor):
            flat[path] = node.detach().contiguous()
        else:
            raise CheckpointError(
                f"{component}/{path} is a {type(node).__name__}, not a tensor")

    walk(tree, "")
    return flat, types


def _flat_shardings(tree: Any) -> dict:
    """{path: Sharding} of a shardings tree, paths as ``_encode`` writes
    them (a NamedTuple of shardings by field)."""
    flat: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, _join(path, str(key)))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for field in node._fields:
                walk(getattr(node, field), _join(path, field))
        elif node is not None:
            flat[path] = node

    walk(tree, "")
    return flat


def _gather_whole(tree: Any, cuts: dict) -> Any:
    """``tree`` with each leaf that ``cuts`` ({path: Sharding}) slices
    gathered whole over its axes (every rank calls this, in the same leaf
    order)."""
    if not cuts:
        return tree
    flat, types = _encode("gather", tree)
    for path, t in flat.items():
        sh = cuts.get(path)
        if sh is None:
            continue
        for dim, ax in enumerate(sh.spec):
            if ax is not None and sh.mesh.shape[ax] > 1:
                t = sh.mesh.all_gather(t, ax, dim=dim)
        flat[path] = t
    return _decode(flat, types)


def _decode(flat: dict, types: dict) -> Any:
    """The tree ``_encode`` flattened: NamedTuples rebuilt at their paths."""
    known = _named_types()

    def build(node, path):
        if path in types:
            cls = known[types[path]]
            return cls(**{f: build(node[f], _join(path, f))
                          for f in cls._fields if f in node})
        if isinstance(node, dict):
            return {k: build(v, _join(path, k)) for k, v in node.items()}
        return node

    return build(unflatten(flat), "")


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    cache: Any = None,
    max_to_keep: int | None = 3,
    shardings: Any = None,
) -> None:
    """Atomically save a composite checkpoint at ``step``. Only non-None
    components are written; ``restore_checkpoint`` returns the same
    composite shape. Steps beyond the newest ``max_to_keep`` are removed.

    ``shardings`` (the composite ``restore_checkpoint`` takes): the trees
    hold this rank's slices; every rank of the mesh calls this, each
    sharded leaf is gathered whole (exact: the bytes move as words), rank 0
    writes the whole tensors and the others wait for it, so the files are
    those of one device and restore onto any mesh."""
    from safetensors.torch import save_file

    if shardings:
        cuts = {name: _flat_shardings(tree) for name, tree in shardings.items()}
        mesh = next(sh.mesh for flat in cuts.values() for sh in flat.values())
        trees = {"params": params, "opt_state": opt_state, "cache": cache}
        whole = {name: _gather_whole(tree, cuts.get(name, {}))
                 for name, tree in trees.items() if tree is not None}
        if mesh.rank == 0:
            save_checkpoint(directory, step, whole["params"], whole.get("opt_state"),
                            whole.get("cache"), max_to_keep)
        import torch.distributed as dist

        dist.barrier(group=mesh.control)
        return
    directory = os.path.abspath(directory)
    final = os.path.join(directory, str(int(step)))
    if os.path.exists(final):
        raise CheckpointError(f"step {step} is already saved under {directory}")
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    trees = {"params": params}
    if opt_state is not None:
        trees["opt_state"] = opt_state
    if cache is not None:
        trees["cache"] = cache
    try:
        order, named = {}, {}
        for name, tree in trees.items():
            path = os.path.join(tmp, f"{name}.safetensors")
            flat, types = _encode(name, tree)
            save_file(flat, path)
            fsync_file(path)
            order[name] = list(flat)
            named[name] = types
        meta = os.path.join(tmp, _META)
        with open(meta, "w", encoding="utf-8") as f:
            # the file format sorts its tensors; the trees come back in the
            # order they were saved in (a sum over the leaves, such as the
            # gradient norm, then runs in the same order after a restore)
            json.dump({"step": int(step), "components": order, "types": named}, f)
        fsync_file(meta)
        fsync_dir(tmp)
        os.replace(tmp, final)
        fsync_dir(directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if max_to_keep is not None:
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
        fsync_dir(directory)
    log.info("saved checkpoint step=%d -> %s", step, directory)


def latest_step(directory: str) -> int | None:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str,
    step: int | None = None,
    target: Any = None,
    shardings: Any = None,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Restore a composite checkpoint: ``{"params": ..., "opt_state": ...,
    "cache": ...}`` with the components that were saved.

    - ``step=None`` restores the latest step.
    - ``device``: where the restored tensors live — the card unless the
      caller asks for the CPU; without a card the default raises.
    - ``target``: a composite of trees matching what was restored, on
      ``device``; each tensor is checked against its target's shape and
      lands in its target's dtype. Without it the tensors come back in the
      dtypes they were saved in.
    - ``shardings``: a composite of trees of ``parallel.sharding.Sharding``
      (``param_shardings``; quantized leaves as NamedTuples of them, a
      missing leaf restores whole): each tensor restores as this rank's
      slice, and only the slice's bytes are read. A ``target`` then holds
      the slices' shapes."""
    from safetensors import safe_open
    from safetensors.torch import load_file

    device = resolve_device(device)
    cuts = {name: _flat_shardings(tree) for name, tree in (shardings or {}).items()}
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise CheckpointError(f"no checkpoints found under {directory}")
    root = os.path.join(directory, str(int(step)))
    meta = os.path.join(root, _META)
    if not os.path.isfile(meta):
        raise CheckpointError(f"no checkpoint for step {step} under {directory}")
    with open(meta, encoding="utf-8") as f:
        saved = json.load(f)
    components, named = saved["components"], saved.get("types", {})
    out = {}
    for name, order in components.items():
        file = os.path.join(root, f"{name}.safetensors")
        if cuts.get(name):
            flat = {}
            with safe_open(file, framework="pt") as f:
                for path in order:
                    sh = cuts[name].get(path)
                    if sh is None:
                        flat[path] = f.get_tensor(path)
                    else:
                        view = f.get_slice(path)
                        flat[path] = view[sh.slices(tuple(view.get_shape()))]
        else:
            loaded = load_file(file)
            flat = {path: loaded[path] for path in order}
        if target is not None and name in target:
            want, _ = _encode(name, target[name])
            if set(want) != set(flat):
                odd = sorted(set(want) ^ set(flat))[:4]
                raise CheckpointError(f"{name} of step {step} does not have the target's "
                                      f"leaves (e.g. {odd})")
            for path, like in want.items():
                if flat[path].shape != like.shape:
                    raise CheckpointError(
                        f"{name}/{path}: saved {tuple(flat[path].shape)}, "
                        f"target {tuple(like.shape)}")
                if like.device.type != device.type:
                    raise CheckpointError(
                        f"{name}/{path}: the target is on {like.device}, the restore "
                        f"on {device}; pass device={str(like.device.type)!r}")
                # a copy into memory of the target's kind: the loaded tensor may
                # sit unaligned in the file's buffer, where CPU kernels sum in
                # another order than on the allocator's own memory
                flat[path] = torch.empty_like(like).copy_(flat[path])
        else:
            flat = {path: t.to(device) for path, t in flat.items()}
        out[name] = _decode(flat, named.get(name, {}))
    return out


# -- drain-time request snapshots --------------------------------------------
#
# A graceful drain persists the still-queued (and deadline-stranded) requests
# so a warm restart loses none. They are host-side token lists and sampling
# knobs in plain JSON, the JAX package's format: v3 records the serving mesh
# as provenance and ``page_size`` as the one restore gate (page size changes
# the paged kernels' summation order). The port adds a ``route`` to each
# request, which the JAX package's reader passes through untouched.

_SNAPSHOT_FILE = "requests.json"
_SNAPSHOT_VERSION = 3
_LEGACY_VERSIONS = (1, 2)


def save_request_snapshots(directory: str, snaps: list[dict], mesh: dict | None = None,
                           page_size: int | None = None) -> None:
    """Atomically and durably persist drain-time request snapshots: tmp
    file, fsync, rename, fsync of the directory. ``mesh`` is provenance
    (None records one device); ``page_size`` is what restore gates on."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _SNAPSHOT_FILE)
    tmp = path + ".tmp"
    payload = {
        "version": _SNAPSHOT_VERSION,
        "mesh": mesh if mesh is not None else dict(SINGLE_DEVICE_MESH),
        "requests": snaps,
    }
    if page_size is not None:
        payload["page_size"] = int(page_size)
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        fsync_file(tmp)
        os.replace(tmp, path)
        fsync_dir(directory)
    except OSError as exc:
        raise CheckpointError(f"could not persist request snapshots to {path}: {exc}",
                              cause=exc)
    log.info("saved %d request snapshots -> %s", len(snaps), path)


def load_request_snapshots(directory: str, expect_mesh: dict | None = None,
                           expect_page_size: int | None = None) -> list[dict]:
    """Load persisted request snapshots; [] when none were saved. A corrupt
    or future-versioned file raises CheckpointError (dropping accepted
    requests silently is what this exists to prevent); a file drained
    under another page size raises ``PageSizeMismatchError``. The mesh is
    provenance: ``expect_mesh`` only drives a log line. v1/v2 files carry
    no page size and load as they are."""
    from fei_tpu_torch.utils.errors import PageSizeMismatchError

    path = os.path.join(directory, _SNAPSHOT_FILE)
    if not os.path.exists(path):
        return []
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise CheckpointError(f"could not read request snapshots from {path}: {exc}",
                              cause=exc)
    version = data.get("version")
    if version != _SNAPSHOT_VERSION and version not in _LEGACY_VERSIONS:
        raise CheckpointError(f"request snapshot version {version!r} in {path} "
                              f"is not the supported version {_SNAPSHOT_VERSION}")
    saved_ps = data.get("page_size")
    if expect_page_size is not None and saved_ps is not None \
            and int(saved_ps) != int(expect_page_size):
        raise PageSizeMismatchError(
            f"request snapshots in {path} were drained under KV page_size="
            f"{saved_ps}, but this engine serves page_size={expect_page_size}; "
            "page size changes the paged kernels' summation order, so a "
            "cross-page_size replay cannot promise byte-identity — restore "
            "with the matching page_size or resubmit the requests",
            ours=int(expect_page_size), theirs=int(saved_ps))
    if expect_mesh is not None:
        saved_mesh = data.get("mesh") or dict(SINGLE_DEVICE_MESH)
        if {k: int(v) for k, v in saved_mesh.items()} != expect_mesh:
            log.info("request snapshots in %s were drained on mesh %s; restoring "
                     "onto mesh %s by replay", path, saved_mesh, expect_mesh)
    return list(data.get("requests", []))


def clear_request_snapshots(directory: str) -> None:
    """Remove the snapshot file (before a warm restart re-admits its
    requests: at-most-once)."""
    try:
        os.remove(os.path.join(directory, _SNAPSHOT_FILE))
    except FileNotFoundError:
        pass
