"""Serving one engine over a mesh of ranks: rank 0 leads, the others follow.

The JAX package has one controller, so one process issues every program
and GSPMD splits it. The port runs one process per rank, so it needs the
mechanism this module is: rank 0 runs the server, the scheduler and the
sampling; every other rank runs ``follow``, a loop that receives each
device call rank 0 makes and makes the same call on its own shard, so the
collectives inside the call pair up.

**One dispatch table.** A function that touches sharded state — a model
forward, the LM head, a cache or pool allocation, a page gather or
scatter — is registered with ``@spmd_op``. Called on rank 0 with an
argument that belongs to a mesh engine (its params, its engine, a cache
or pool it allocated), the wrapper broadcasts a header — the op's name,
its arguments with device tensors copied to the host, and handles in
place of the sharded state and of the mesh itself (``moe_mesh``) — and
then runs the op itself with
``kernel_mesh``. A follower decodes the header against its own engine and
shard store and runs the same op. Called with ``kernel_mesh`` (as the ops
call each other, and as followers call them), it runs directly. Called on
a single-device engine, nothing is broadcast.

**Sharded state** is what a rank allocates through an op marked
``creates=True`` (the dense KV cache and the page pool): rank 0 tags its
shard's first tensor with a key, each follower stores its own shard under
the same key, and a header names the cache by its key. Block tables,
lengths, tokens and positions travel by value with every header: the
followers hold no allocator. When rank 0's shard is garbage-collected its
key rides the next header and the followers drop theirs.

**Ranks start themselves.** ``launch`` (called by
``InferenceEngine.from_config`` for a mesh of more than one rank with no
process group yet) spawns the follower processes with
``torch.multiprocessing``; each joins the group, builds its engine with
the same arguments and follows until rank 0 closes the engine. With a
group already initialized (``parallel/distributed.initialize`` on every
host, or a caller's own processes) every rank calls ``from_config`` and
the ranks other than 0 follow inside it.
"""

from __future__ import annotations

import atexit
import functools
import importlib
import itertools
import os
import socket
import threading
import weakref
from typing import Callable

import torch

from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.serving")

OPS: dict[str, tuple[Callable, bool]] = {}
_STOP = "__stop__"


def spmd_op(fn=None, *, creates: bool = False):
    """Register ``fn`` (which takes ``kernel_mesh=None``) in the dispatch
    table; the returned wrapper broadcasts rank 0's calls on a mesh engine
    (see the module docstring). ``creates``: the result is sharded state
    that later headers name by key."""
    if fn is None:
        return functools.partial(spmd_op, creates=creates)
    name = f"{fn.__module__}:{fn.__qualname__}"
    OPS[name] = (fn, creates)

    @functools.wraps(fn)
    def call(*args, kernel_mesh=None, **kw):
        if kernel_mesh is None:
            lead = _leader_of(args)
            if lead is not None:
                return lead.run(name, args, kw)
        return fn(*args, kernel_mesh=kernel_mesh, **kw)

    return call


def _leader_of(args):
    """The Leader of the first argument that belongs to a mesh engine: its
    params (``MeshParams``), the engine, or a cache/pool whose first tensor
    carries the tag."""
    for a in args:
        lead = getattr(a, "_spmd_leader", None)
        if lead is not None:
            return lead
        if isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
            lead = getattr(a[0], "_spmd_leader", None)
            if lead is not None:
                return lead
    return None


class MeshParams(dict):
    """A rank's param dict, tagged with rank 0's Leader so the model
    functions that take it broadcast their calls."""

    _spmd_leader = None


def _is_state(a) -> bool:
    """A KVCache or PagedKVCache (NamedTuples whose first field is the
    sharded K tensor)."""
    return isinstance(a, tuple) and hasattr(a, "_fields") and a and \
        a._fields[0] in ("k", "k_pages")


class Leader:
    """Rank 0's side: broadcasts each op's header, then runs the op."""

    def __init__(self, engine, mesh):
        self.engine = engine
        self.mesh = mesh
        self._lock = threading.RLock()
        self._keys = itertools.count(1)
        self._freed: list[int] = []
        self.closed = False
        self.dispatches = 0
        engine._spmd_leader = self
        if not isinstance(engine.params, MeshParams):
            engine.params = MeshParams(engine.params)
        engine.params._spmd_leader = self
        atexit.register(_stop_at_exit, weakref.ref(self))

    # -- header encoding ----------------------------------------------------

    def _encode(self, a):
        if a is self.engine:
            return ("E",)
        if a is self.engine.params:
            return ("P",)
        if a is self.mesh:
            return ("M",)
        if _is_state(a):
            key = getattr(a[0], "_spmd_key", None)
            if key is None:
                raise EngineError(
                    f"a {type(a).__name__} that the mesh engine did not allocate "
                    "reached a sharded op (allocate through engine.new_cache)")
            rest = {f: self._encode(getattr(a, f)) for f in a._fields[2:]
                    if not f.endswith("scales")}
            return ("S", key, rest)
        if isinstance(a, torch.Tensor):
            return ("T", a.detach().cpu())
        if isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
            return ("L", type(a) is tuple, [self._encode(x) for x in a])
        if isinstance(a, dict) and not isinstance(a, MeshParams):
            return ("D", {k: self._encode(v) for k, v in a.items()})
        return ("V", a)

    def _tag(self, out, key: int) -> None:
        t = out[0]
        t._spmd_key = key
        t._spmd_leader = self
        weakref.finalize(t, self._freed.append, key)

    def run(self, name: str, args, kw):
        fn, creates = OPS[name]
        with self._lock:
            if self.closed:
                raise EngineError("the mesh's follower ranks have stopped; "
                                  "this engine was closed")
            key = next(self._keys) if creates else None
            freed = []
            while self._freed:  # finalizers append from any thread
                freed.append(self._freed.pop())
            self.mesh.broadcast_header({
                "op": name, "key": key, "free": freed,
                "args": [self._encode(a) for a in args],
                "kw": {k: self._encode(v) for k, v in kw.items()},
            })
            self.dispatches += 1
            out = fn(*args, kernel_mesh=self.mesh, **kw)
            if creates:
                self._tag(out, key)
            return out

    def stop(self) -> None:
        """Tell the followers to leave their loop; join the processes this
        rank started and leave the process group it created. Idempotent."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            try:
                self.mesh.broadcast_header({"op": _STOP})
            except Exception as exc:  # noqa: BLE001 — a dead peer: still tear down
                log.warning("could not stop the follower ranks: %r", exc)
        self.engine = None  # a stopped leader keeps no engine alive
        for p in self.mesh.launched:
            p.join(timeout=30)
            if p.is_alive():
                log.warning("follower pid %s did not exit; terminating it", p.pid)
                p.terminate()
        if self.mesh.launched:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.mesh.launched = []


def _stop_at_exit(ref) -> None:
    lead = ref()
    if lead is not None:
        lead.stop()


def follow(engine, mesh) -> int:
    """A follower rank's loop: run each op rank 0 broadcasts on this rank's
    engine and shards until the stop header. Returns the ops run."""
    store: dict[int, object] = {}
    dev = engine.device

    def decode(e):
        kind = e[0]
        if kind == "E":
            return engine
        if kind == "P":
            return engine.params
        if kind == "M":
            return mesh
        if kind == "S":
            base = store[e[1]]
            return base._replace(**{f: decode(v) for f, v in e[2].items()})
        if kind == "T":
            return e[1].to(dev)
        if kind == "L":
            items = [decode(x) for x in e[2]]
            return tuple(items) if e[1] else items
        if kind == "D":
            return {k: decode(v) for k, v in e[1].items()}
        return e[1]

    n = 0
    while True:
        header = mesh.broadcast_header()
        for key in header.get("free", ()):
            store.pop(key, None)
        name = header["op"]
        if name == _STOP:
            return n
        if name not in OPS:
            importlib.import_module(name.split(":")[0])
        fn, creates = OPS[name]
        out = fn(*[decode(a) for a in header["args"]], kernel_mesh=mesh,
                 **{k: decode(v) for k, v in header["kw"].items()})
        if creates:
            store[header["key"]] = out
        n += 1


# -- self-started ranks ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: torch.device, rank: int, shared: bool) -> torch.device:
    """The device of ``rank``: the CPU, the one shared card, or card
    ``rank`` when every rank has its own."""
    if device.type != "cuda":
        return torch.device("cpu")
    if shared:
        return torch.device("cuda", device.index or 0)
    return torch.device("cuda", rank)


def _follower_main(rank: int, world: int, addr: str, backend: str, shared: bool,
                   device: str, shape: dict, name: str, kwargs: dict) -> None:
    """A spawned follower: join the group, build the engine (which follows
    rank 0 until it closes), leave the group."""
    import torch.distributed as dist

    from fei_tpu_torch.engine.engine import InferenceEngine
    from fei_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT, make_mesh

    dev = rank_device(torch.device(device), rank, shared)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    threading.Thread(target=_exit_with_parent, args=(os.getppid(),), daemon=True).start()
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        mesh = make_mesh(shape, device=dev)
        InferenceEngine.from_config(name, mesh=mesh, device=dev, **kwargs)
    finally:
        dist.destroy_process_group()


def _exit_with_parent(ppid: int) -> None:
    """A follower whose rank 0 died without stopping it has nothing to
    serve: exit rather than wait on its broadcast for days."""
    import time

    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(3)


def launch(shape: dict, device: torch.device, name: str, kwargs: dict):
    """Start the followers of a ``shape`` mesh from this process (rank 0)
    and bind the mesh: ``torch.multiprocessing`` spawns ranks 1.., each
    running ``from_config(name, **kwargs)`` on its own device; the group
    uses NCCL when each rank has a card of its own and gloo when they
    share one (``distributed.choose_backend``), stated in the log."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fei_tpu_torch.parallel.distributed import choose_backend
    from fei_tpu_torch.parallel.mesh import AXES, COLLECTIVE_TIMEOUT, make_mesh

    world = int(np.prod([int(shape.get(ax, 1)) for ax in AXES]))
    backend, shared = choose_backend(device.type, world)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(1, world):
        p = ctx.Process(target=_follower_main, daemon=True, args=(
            r, world, addr, backend, shared, str(device), dict(shape), name, kwargs))
        p.start()
        procs.append(p)
    dev = rank_device(device, 0, shared)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=addr, world_size=world, rank=0,
                                timeout=COLLECTIVE_TIMEOUT)
        mesh = make_mesh(shape, device=dev)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    mesh.launched = procs
    log.info("mesh %s: %d ranks over %s (%s), rank 0 on %s",
             shape, world, backend, "sharing one device" if shared else "one card each",
             dev)
    return mesh
