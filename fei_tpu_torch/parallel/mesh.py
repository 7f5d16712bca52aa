"""The serving mesh over ranks (counterpart of fei_tpu/parallel/mesh.py).

The JAX package has one controller: one process runs every device of a
``jax.sharding.Mesh`` and XLA inserts the collectives. The port is SPMD
over ``torch.distributed``: one process per rank, each owning one device,
and the collectives are explicit calls. A ``Mesh`` is one rank's view of
the grid: the axis sizes in the reference's order ``AXES`` (dp, tp, ep,
sp, pp), this rank's coordinate on each axis, and one process group per
axis of size > 1 that holds the ranks differing from this one on that
axis alone. Ranks are laid out row-major over ``AXES``, as
``np.asarray(devices).reshape(sizes)`` lays out the reference's devices.

A mesh built without an initialized process group is *unbound*: geometry
and coordinates only (enough to slice weights, tag records and parse the
environment), no collectives. ``make_mesh`` binds to the default group
when there is one.

``all_gather`` moves the bytes of its tensors as 32-bit words (or bytes),
so a gather is exact for every dtype and never depends on the backend's
support for it; gloo gathers CUDA tensors this way.
"""

from __future__ import annotations

import math
import os
import re
import time
from datetime import timedelta

import numpy as np
import torch

AXES = ("dp", "tp", "ep", "sp", "pp")

# env knob that promotes the sharded paged path to the engine's serving
# mode: FEI_TPU_MESH=tp2 / tp2dp2 / "dp=2,tp=4" / auto; unset (or ms1 /
# single / off) keeps the single-device path
MESH_ENV = "FEI_TPU_MESH"

# "single-device" spellings: ms1 is the tag of the unsharded arm, so it
# round-trips through FEI_TPU_MESH too
_SINGLE = ("", "0", "off", "none", "single", "ms1")

_COMPACT_RX = re.compile(r"(dp|tp|ep|sp|pp)(\d+)")

# how long a follower may wait for rank 0's next dispatch (an idle server
# sends none)
_IDLE_TIMEOUT = timedelta(days=7)

# the data-plane collectives' timeout: a peer that died leaves the others
# raising after it, never hanging
COLLECTIVE_TIMEOUT = timedelta(seconds=600)


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse a mesh spec string into an axis-size dict.

    Two spellings are accepted: the explicit 'dp=2,tp=4' form and the
    compact env-friendly 'tp4dp2' form ('FEI_TPU_MESH=tp2dp1').
    """
    spec = spec.strip()
    if "=" not in spec and spec:
        matches = list(_COMPACT_RX.finditer(spec))
        if not matches or "".join(m.group(0) for m in matches) != spec:
            raise ValueError(
                f"unparseable mesh spec {spec!r}; expected 'tp2dp2' or "
                f"'dp=2,tp=2' over axes {AXES}"
            )
        return {m.group(1): int(m.group(2)) for m in matches}
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; valid: {AXES}")
        out[name] = int(val)
    return out


def best_mesh_shape(
    n_devices: int, num_kv_heads: int = 8, num_experts: int = 0
) -> dict[str, int]:
    """Heuristic factorization of n_devices into (dp, tp, ep).

    TP is capped at num_kv_heads (the KV cache shards over kv heads); MoE
    models spend a factor on ep up to num_experts; the remainder goes to dp.
    """
    remaining = n_devices
    ep = 1
    if num_experts > 1:
        ep = math.gcd(remaining, num_experts)
        remaining //= ep
    tp = math.gcd(remaining, num_kv_heads)
    remaining //= tp
    return {"dp": remaining, "tp": tp, "ep": ep}


def _words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as int32 words (uint8 when its bytes do
    not split into words): the unit every collective here moves."""
    t = t.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    if (t.shape[-1] * t.element_size()) % 4 == 0:
        return t.view(torch.int32)
    return t.view(torch.uint8)


class _AllReduce(torch.autograd.Function):
    """Sum over an axis forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh._all_reduce(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllGather(torch.autograd.Function):
    """Gather over an axis forward; backward, the rank's own chunk of the
    replicated gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        part = grad.chunk(mesh.shape[ctx.axis], dim=ctx.dim)[mesh.coords[ctx.axis]]
        return part.contiguous(), None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward, sum of the gradient over an axis backward
    (Megatron's f)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_reduce(grad.contiguous(), ctx.axis), None, None


class Mesh:
    """One rank's view of the serving mesh (see the module docstring).

    ``shape`` maps every axis of ``AXES`` to its size; ``coords`` this
    rank's index on each; ``groups`` the process group of each axis of size
    > 1 (empty for an unbound mesh); ``device`` the rank's device;
    ``backend`` the data-plane backend ("nccl", "gloo" or None unbound).
    ``stats`` sums the host wall time spent inside collectives per axis,
    with their counts."""

    def __init__(self, shape: dict[str, int], rank: int = 0, device=None,
                 backend: str | None = None, groups: dict | None = None,
                 control=None):
        sizes = [int(shape.get(ax, 1)) for ax in AXES]
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axes must be >= 1, got {dict(zip(AXES, sizes))}")
        self.shape = dict(zip(AXES, sizes))
        self.axis_names = AXES
        self.size = int(np.prod(sizes))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = {ax: int(c) for ax, c in
                       zip(AXES, np.unravel_index(self.rank, sizes))}
        # rank ids laid out over the axes (the reference's Mesh.devices)
        self.devices = np.arange(self.size).reshape(sizes)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.backend = backend
        self.groups = dict(groups or {})
        self.control = control  # the gloo group rank 0's dispatch headers use
        self.stats: dict[str, list] = {}
        self.launched: list = []  # follower processes this rank started

    def __repr__(self) -> str:
        return (f"Mesh({mesh_tag(self)}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    @property
    def bound(self) -> bool:
        """True when the mesh has process groups (collectives work)."""
        return self.control is not None or bool(self.groups)

    # -- collectives ----------------------------------------------------------

    def _timed(self, axis: str, t0: float) -> None:
        s = self.stats.setdefault(axis, [0.0, 0])
        s[0] += time.perf_counter() - t0
        s[1] += 1

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``t`` of this rank's ``axis`` group along
        ``dim``, in coordinate order. Exact: the bytes move as words.
        Autograd goes through it: backward, each rank keeps its own
        chunk of the (replicated) gradient."""
        n = self.shape[axis]
        if n == 1:
            return t
        if t.requires_grad and torch.is_grad_enabled():
            return _AllGather.apply(t, self, axis, dim)
        return self._all_gather(t, axis, dim)

    def _all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.shape[axis]
        import torch.distributed as dist

        t0 = time.perf_counter()
        w = _words(t)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=self.groups[axis])
        self._timed(axis, t0)
        shape = t.shape if t.dim() else (1,)
        parts = [p.view(t.dtype).reshape(shape) for p in parts]
        return torch.cat(parts, dim=dim)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` over this rank's ``axis`` group in fp32 (the
        Megatron partial sums), returned in ``t``'s dtype. Autograd goes
        through it (Megatron's g: the gradient passes unchanged to each
        partial, as every rank holds the whole loss)."""
        if self.shape[axis] == 1:
            return t
        if t.requires_grad and torch.is_grad_enabled():
            return _AllReduce.apply(t, self, axis)
        return self._all_reduce(t, axis)

    def _all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        x = t.float().contiguous()
        dist.all_reduce(x, group=self.groups[axis])
        self._timed(axis, t0)
        return x.to(t.dtype)

    def _staged(self, t: torch.Tensor) -> bool:
        """True when ``t``'s bytes go through host memory: gloo moves
        point-to-point and all_to_all traffic between host buffers only,
        so a device tensor is staged through a pinned copy (counted in
        ``stats`` under ``<axis>.staged``). NCCL moves device tensors."""
        return self.backend != "nccl" and t.device.type != "cpu"

    def _host(self, w: torch.Tensor) -> torch.Tensor:
        out = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        out.copy_(w)
        return out

    def _count_staged(self, axis: str, nbytes: int) -> None:
        s = self.stats.setdefault(f"{axis}.staged", [0, 0])
        s[0] += nbytes
        s[1] += 1

    def _peer(self, axis: str, coord: int) -> int:
        """The global rank at ``coord`` on ``axis``, the others as mine."""
        import torch.distributed as dist

        return dist.get_global_rank(self.groups[axis], coord)

    def ppermute(self, t: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``lax.ppermute`` over ``axis``: ``perm`` lists (source, dest)
        coordinates; this rank sends ``t`` to its dest and returns what its
        source sent, or zeros where no pair names it as a dest (the
        pipeline's ``[(i, i + 1)]``; the ring's ``[(i, (i + 1) % n)]``
        rotates). Exact: the bytes move as words."""
        n = self.shape[axis]
        me = self.coords[axis]
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if n == 1:
            return t.clone() if src else torch.zeros_like(t)
        import torch.distributed as dist

        t0 = time.perf_counter()
        w = _words(t)
        staged = self._staged(t)
        send = self._host(w) if staged and dst else w
        recv = torch.empty(w.shape, dtype=w.dtype,
                           device="cpu" if staged else w.device,
                           pin_memory=staged)
        ops = [dist.P2POp(dist.isend, send, self._peer(axis, d), self.groups[axis])
               for d in dst]
        ops += [dist.P2POp(dist.irecv, recv, self._peer(axis, s), self.groups[axis])
                for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if staged:
            self._count_staged(axis, send.numel() * send.element_size() * len(dst)
                               + recv.numel() * recv.element_size() * len(src))
        self._timed(axis, t0)
        if not src:
            return torch.zeros_like(t)
        return recv.to(t.device, non_blocking=False).view(t.dtype).reshape(t.shape)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)`` over ``axis``: ``t`` splits
        into n chunks along ``split_dim``, chunk j goes to coordinate j, and
        the chunks received concatenate along ``concat_dim`` in source
        order. Exact: the bytes move as words."""
        n = self.shape[axis]
        if n == 1:
            return t
        import torch.distributed as dist

        split_dim %= t.dim()
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dimension {split_dim} ({t.shape[split_dim]}) "
                             f"does not split over {axis}={n}")
        t0 = time.perf_counter()
        x = t.movedim(split_dim, 0).contiguous()
        w = _words(x)
        staged = self._staged(t)
        send = self._host(w) if staged else w
        recv = torch.empty_like(send, pin_memory=staged) if staged else torch.empty_like(w)
        dist.all_to_all_single(recv, send, group=self.groups[axis])
        if staged:
            self._count_staged(axis, 2 * send.numel() * send.element_size())
        self._timed(axis, t0)
        got = recv.to(t.device).view(t.dtype).reshape(x.shape)
        parts = [p.movedim(0, split_dim) for p in got.chunk(n, dim=0)]
        return torch.cat(parts, dim=concat_dim % t.dim())

    def sum_grad(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Identity forward; backward, the gradient all_reduced over
        ``axis``: where a replicated activation enters a rank's own slice
        of the work (its heads, its columns, its experts), each rank's
        backward holds that slice's share of the gradient."""
        if self.shape[axis] == 1 or not t.requires_grad:
            return t
        return _SumGrad.apply(t, self, axis)

    def broadcast_header(self, obj=None):
        """Rank 0 sends ``obj`` to every rank over the control group; the
        others receive and return it."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]


def make_mesh(shape: dict[str, int] | str | None = None, devices=None,
              rank: int | None = None, device=None) -> Mesh:
    """Build a Mesh with the canonical axis names (missing axes get size 1).

    ``shape`` may be a dict, a 'dp=2,tp=4' string, or None (all ranks on
    the tp axis). ``devices`` is the rank count (an int or a sequence);
    it defaults to the default process group's world size. With a default
    group initialized the mesh binds to it: every rank must call this, in
    the same order (it creates one process group per axis), and ``rank``
    is the group's. Without one it is unbound, at ``rank`` (default 0)."""
    import torch.distributed as dist

    bound = dist.is_available() and dist.is_initialized()
    if devices is None:
        n = dist.get_world_size() if bound else None
    else:
        n = devices if isinstance(devices, int) else len(devices)
    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    if shape is None:
        shape = {"tp": n or 1}
    sizes = [int(shape.get(ax, 1)) for ax in AXES]
    total = int(np.prod(sizes))
    if n is not None and total != n:
        raise ValueError(
            f"mesh shape {dict(zip(AXES, sizes))} needs {total} devices, have {n}"
        )
    if not bound:
        return Mesh(shape, rank=rank or 0, device=device)
    if dist.get_world_size() != total:
        raise ValueError(
            f"mesh shape {dict(zip(AXES, sizes))} needs {total} ranks, the "
            f"process group has {dist.get_world_size()}"
        )
    me = dist.get_rank()
    ids = np.arange(total).reshape(sizes)
    groups = {}
    for a, ax in enumerate(AXES):
        if sizes[a] == 1:
            continue
        # every rank creates every group of the axis, in the same order
        for row in np.moveaxis(ids, a, -1).reshape(-1, sizes[a]):
            g = dist.new_group(ranks=[int(r) for r in row],
                               timeout=COLLECTIVE_TIMEOUT)
            if me in row:
                groups[ax] = g
    control = dist.new_group(ranks=list(range(total)), backend="gloo",
                             timeout=_IDLE_TIMEOUT)
    return Mesh(shape, rank=me, device=device, backend=dist.get_backend(),
                groups=groups, control=control)


def single_device_mesh() -> Mesh:
    return Mesh({"tp": 1})


# -- engine-facing helpers ---------------------------------------------------
#
# Everything below treats mesh=None (the single-device engine) as the
# (1,1,1,1,1) mesh, so callers never branch on "is there a mesh".


def axis_size(mesh: Mesh | None, name: str) -> int:
    """Size of a mesh axis; 1 for a missing axis or no mesh at all."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(name, 1))


def has_axis(mesh: Mesh | None, name: str) -> bool:
    """True when the axis exists with size > 1 (i.e. it actually shards)."""
    return axis_size(mesh, name) > 1


def mesh_geometry(mesh: Mesh | None) -> dict[str, int]:
    """Canonical serializable geometry {axis: size} over ALL axes (size-1
    included), identical for mesh=None and an all-ones mesh: the geometry
    snapshots and the journal record."""
    return {ax: axis_size(mesh, ax) for ax in AXES}


def mesh_tag(mesh: Mesh | None) -> str:
    """Compact tag: 'ms1' for a single device, else e.g. 'tp2dp2'
    (sharding axes only, canonical order) — records and /health."""
    parts = [f"{ax}{axis_size(mesh, ax)}" for ax in AXES
             if axis_size(mesh, ax) > 1]
    return "".join(parts) if parts else "ms1"


def visible_devices() -> int:
    """The devices ``auto`` spreads over: the visible cards, else 1."""
    return max(1, torch.cuda.device_count()) if torch.cuda.is_available() else 1


def env_mesh_tag(env: str | None = None) -> str:
    """The canonical tag ('ms1', 'tp2dp2', …) the environment's
    FEI_TPU_MESH spec denotes, without building a mesh. Unresolvable specs
    come back verbatim rather than raising: a tagging helper must never
    sink the caller."""
    spec = env if env is not None else os.environ.get(MESH_ENV, "")
    spec = spec.strip().lower()
    if spec in _SINGLE:
        return "ms1"
    try:
        if spec == "auto":
            shape = best_mesh_shape(visible_devices())
        else:
            shape = parse_mesh_shape(spec)
    except Exception:  # noqa: BLE001 — tagging must never raise
        return spec
    parts = [f"{ax}{int(shape[ax])}" for ax in AXES
             if int(shape.get(ax, 1)) > 1]
    return "".join(parts) if parts else "ms1"


def mesh_from_env(
    num_kv_heads: int = 8,
    num_experts: int = 0,
    devices=None,
    env: str | None = None,
) -> Mesh | None:
    """The mesh requested by ``FEI_TPU_MESH``, or None for a single device.

    - unset / '' / 'ms1' / 'single' / 'off': None (single-device path)
    - 'auto': best_mesh_shape over the visible cards
    - 'tp2', 'tp2dp2', 'dp=2,tp=4': explicit shape. Ranks may share a
      card, so any size is legal unless ``devices`` (a count or a
      sequence) caps it.

    The mesh comes back unbound (rank 0's geometry); the engine binds it
    when it starts its ranks."""
    spec = env if env is not None else os.environ.get(MESH_ENV, "")
    spec = spec.strip().lower()
    if spec in _SINGLE:
        return None
    n = None if devices is None else (devices if isinstance(devices, int) else len(devices))
    if spec == "auto":
        shape = best_mesh_shape(
            n or visible_devices(), num_kv_heads=num_kv_heads, num_experts=num_experts
        )
    else:
        shape = parse_mesh_shape(spec)
    sizes = [int(shape.get(ax, 1)) for ax in AXES]
    need = int(np.prod(sizes))
    if n is not None and need > n:
        raise ValueError(f"{MESH_ENV}={spec!r} needs {need} devices, have {n}")
    tp = int(shape.get("tp", 1))
    if tp > 1 and num_kv_heads % tp:
        # fail at engine construction, not deep inside the first dispatch
        raise ValueError(
            f"{MESH_ENV}={spec!r}: tp={tp} must divide the model's "
            f"{num_kv_heads} kv heads (the page pool shards over them)"
        )
    if need == 1:
        return None
    return Mesh(shape)
