"""Model and optimizer checkpoints (counterpart of the model-state half of
fei_tpu/engine/checkpoint.py; the drain-time request snapshots further down
that file wait for the survival slice, roadmap B4).

Step-numbered directories with retention, one atomic composite save per
step: ``<directory>/<step>/params.safetensors`` and, when given,
``opt_state.safetensors``, with a ``meta.json`` beside them. Where the JAX
package goes through orbax, this module writes the tensors with
``safetensors.torch`` into a temporary directory, fsyncs the files and the
directory, and renames it into place: a crash leaves either the whole step
or none of it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from fei_tpu_torch.engine.engine import resolve_device
from fei_tpu_torch.utils.errors import CheckpointError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.tree import flatten, unflatten

log = get_logger("engine.checkpoint")

_META = "meta.json"
_COMPONENTS = ("params", "opt_state")


def fsync_file(path: str) -> None:
    """fsync an already-written file by path. tmp-write + ``os.replace``
    alone survives a process crash but NOT a host power cut: the rename
    can hit the disk before the data blocks do, leaving a torn or empty
    file behind a durable name."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(directory: str) -> None:
    """fsync a directory so a rename/create/unlink inside it is durable
    (the directory entry itself lives in the parent's data blocks).
    Best-effort on platforms whose directories reject O_RDONLY fsync."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _steps(directory: str) -> list[int]:
    """The complete steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, _META))
    )


def _flat_tensors(component: str, tree: dict) -> dict:
    flat = flatten(tree)
    for path, leaf in flat.items():
        if not isinstance(leaf, torch.Tensor):
            raise CheckpointError(
                f"{component}/{path} is a {type(leaf).__name__}, not a tensor: quantized "
                "leaves in checkpoints come with the survival slice (roadmap B4)")
    return {path: leaf.detach().contiguous() for path, leaf in flat.items()}


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    cache: Any = None,
    max_to_keep: int | None = 3,
) -> None:
    """Atomically save a composite checkpoint at ``step``. Only non-None
    components are written; ``restore_checkpoint`` returns the same
    composite shape. Steps beyond the newest ``max_to_keep`` are removed."""
    from safetensors.torch import save_file

    if cache is not None:
        raise NotImplementedError(
            "checkpointing a KV cache comes with the survival slice (roadmap B4)")
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
    try:
        order = {}
        for name, tree in trees.items():
            path = os.path.join(tmp, f"{name}.safetensors")
            flat = _flat_tensors(name, tree)
            save_file(flat, path)
            fsync_file(path)
            order[name] = list(flat)
        meta = os.path.join(tmp, _META)
        with open(meta, "w", encoding="utf-8") as f:
            # the file format sorts its tensors; the trees come back in the
            # order they were saved in (a sum over the leaves, such as the
            # gradient norm, then runs in the same order after a restore)
            json.dump({"step": int(step), "components": order}, f)
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
    """Restore a composite checkpoint: ``{"params": ..., "opt_state": ...}``
    with the components that were saved.

    - ``step=None`` restores the latest step.
    - ``device``: where the restored tensors live — the card unless the
      caller asks for the CPU; without a card the default raises.
    - ``target``: a composite of trees matching what was saved, on
      ``device``; each tensor is checked against its target's shape and
      lands in its target's dtype. Without it the tensors come back in the
      dtypes they were saved in."""
    from safetensors.torch import load_file

    device = resolve_device(device)
    if shardings is not None:
        raise NotImplementedError(
            "sharded restore comes with the parallelism slice (roadmap C4)")
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
        components = json.load(f)["components"]
    out = {}
    for name, order in components.items():
        loaded = load_file(os.path.join(root, f"{name}.safetensors"))
        flat = {path: loaded[path] for path in order}
        if target is not None and name in target:
            want = flatten(target[name])
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
        out[name] = unflatten(flat)
    return out
