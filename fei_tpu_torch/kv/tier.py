"""Host-RAM → disk tier for spilled KV pages (a copy of fei_tpu/kv/tier.py).

The tier ladder:

  device pool  --spill-->  RAM tier  --demote-->  disk tier  --evict--> gone
               <-fetch--             <--fetch---

``KVTierStore`` is a byte-budgeted LRU at each rung. ``put`` lands in RAM
and, past ``ram_bytes``, demotes the coldest entries to disk on a
background writer thread (the spill path never blocks the scheduler loop
on a file write); past ``disk_bytes`` the coldest files are deleted. An
evicted session silently rejoins the token-replay path, the always-correct
fallback for *every* miss here. Entries in flight to disk stay fetchable
from a pending map, so a demotion race costs nothing.

Disk entries are written atomically (tmp + os.replace) with a versioned
header and a sha256 over the payload: a torn or bit-rotted file fails
closed as ``KVTierError`` and the entry is dropped, never served.

The wire format (FKV1) is the JAX package's byte for byte. numpy has no
bfloat16 without ``ml_dtypes``, which the port does not load: bf16 pages
travel here as their 2-byte words (``BF16_WORDS``, uint16) and are named
``"bfloat16"`` in the manifest, as the JAX package names them. No pool is
ever uint16, so the name is unambiguous both ways.

Fault points ``kv.spill`` / ``kv.fetch`` (engine/faults.py) fire inside
``put``/``fetch``: an I/O error, a corrupt checksum or a slow-fetch hang
surfaces as an exception the scheduler converts into plain replay.

The content-addressed (CDN) layer rides the same store: ``cas:*`` keys
(kv/content.py) land via ``put_if_absent`` (N sessions over one prompt
prefix share one copy), and live sessions ``pin`` the entry so budget
pressure cannot evict bytes in use (an explicit ``drop`` still wins).

Variables (read by ``TierConfig.from_env``, the JAX package's):
``FEI_TPU_KV_TIER`` (off | ram | disk), ``FEI_TPU_KV_RAM_BYTES`` (256 MiB),
``FEI_TPU_KV_DISK_BYTES`` (1 GiB), ``FEI_TPU_KV_DISK_DIR`` (a directory
under the system's temporary directory).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import struct
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.utils.errors import KVTierError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("kv.tier")

_MAGIC = b"FKV1"
_VERSION = 1

# bf16 in host memory: its 2-byte words ("bfloat16" on the wire)
BF16_WORDS = np.dtype("<u2")


def wire_dtype(dt: np.dtype) -> str:
    """The manifest name of a host array's dtype."""
    return "bfloat16" if dt == BF16_WORDS else str(dt)


def host_dtype(name: str) -> np.dtype:
    """The host dtype an array named ``name`` in a manifest is read as."""
    return BF16_WORDS if name == "bfloat16" else np.dtype(name)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


_SIZE_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*([kmgt]?)i?b?$", re.IGNORECASE)


def parse_size(text, default: int) -> int:
    """Forgiving human-readable byte sizes for the FEI_TPU_KV_*_BYTES
    knobs: ``268435456``, ``256MiB``, ``4g``, ``1.5 G``, ``512kb``.
    Binary multipliers throughout — a fleet config that says ``4g``
    means 4 GiB of budget, not a 7% haircut — and unparseable input
    falls back to ``default`` with a warning rather than refusing to
    boot (a typo'd budget must not take a replica out of rotation)."""
    if text is None:
        return default
    s = str(text).strip()
    if not s:
        return default
    m = _SIZE_RE.match(s)
    if not m:
        log.warning("unparseable byte size %r; using default %d",
                    text, default)
        return default
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20,
            "g": 1 << 30, "t": 1 << 40}[m.group(2).lower()]
    return int(float(m.group(1)) * mult)


@dataclass(frozen=True)
class TierConfig:
    """Parsed ``FEI_TPU_KV_*`` knobs. ``mode``: ``off`` (no tier — replay
    only), ``ram`` (spill to host RAM, drop
    past the budget), ``disk`` (RAM + demotion to checksummed files)."""

    mode: str = "off"
    ram_bytes: int = 256 * 1024 * 1024
    disk_bytes: int = 1024 * 1024 * 1024
    disk_dir: str = ""

    @staticmethod
    def from_env() -> "TierConfig":
        mode = os.environ.get("FEI_TPU_KV_TIER", "off").strip().lower()
        if mode not in ("off", "ram", "disk"):
            log.warning("unknown FEI_TPU_KV_TIER %r; tier disabled", mode)
            mode = "off"
        return TierConfig(
            mode=mode,
            ram_bytes=parse_size(
                os.environ.get("FEI_TPU_KV_RAM_BYTES"), 256 * 1024 * 1024
            ),
            disk_bytes=parse_size(
                os.environ.get("FEI_TPU_KV_DISK_BYTES"), 1024 * 1024 * 1024
            ),
            disk_dir=os.environ.get("FEI_TPU_KV_DISK_DIR", "")
            or os.path.join(tempfile.gettempdir(), "fei_kv_tier"),
        )

    @property
    def enabled(self) -> bool:
        return self.mode in ("ram", "disk")

    @property
    def disk_enabled(self) -> bool:
        return self.mode == "disk"


@dataclass
class PageEntry:
    """One spilled sequence's pages, page-axis-first host arrays (the
    ``pagesio.gather_pages`` layout) plus the geometry needed to refuse
    a mismatched scatter. ``n_tokens`` is the device ``lengths`` value
    the entry restores (== len(_prefill_ids) for a settled slot).
    ``fingerprint`` is the INVARIANT geometry half (mesh-independent);
    ``layout`` is the tp shard layout that produced the arrays —
    provenance only (None on blobs written before mesh elasticity, read
    as canonical): consumers reshard via ``pagesio.canonicalize_arrays``
    instead of refusing a layout skew."""

    key: str
    n_tokens: int
    page_size: int
    fingerprint: dict
    arrays: dict[str, np.ndarray] = field(default_factory=dict)
    layout: dict | None = None

    @property
    def n_pages(self) -> int:
        a = self.arrays.get("k_pages")
        return 0 if a is None else int(a.shape[0])

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values()))


# -- wire format -----------------------------------------------------------


def pack_entry(entry: PageEntry, extra: dict | None = None) -> bytes:
    """Entry -> one self-describing blob:
    ``FKV1 | u32 header_len | header json | payload``. The header carries
    a manifest (name/dtype/shape per array) and a sha256 over the payload
    so disk rot and truncation fail closed. ``extra`` rides in the header
    (migration stores the prompt ids there)."""
    names = sorted(entry.arrays)
    payload = b"".join(
        np.ascontiguousarray(entry.arrays[n]).tobytes() for n in names
    )
    header = {
        "version": _VERSION,
        "key": entry.key,
        "n_tokens": int(entry.n_tokens),
        "page_size": int(entry.page_size),
        "fingerprint": entry.fingerprint,
        **({"layout": entry.layout} if entry.layout else {}),
        "manifest": [
            {
                "name": n,
                "dtype": wire_dtype(entry.arrays[n].dtype),
                "shape": list(entry.arrays[n].shape),
            }
            for n in names
        ],
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    if extra:
        header["extra"] = extra
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack("<I", len(raw)) + raw + payload


def unpack_entry(blob: bytes) -> tuple[PageEntry, dict]:
    """Blob -> (entry, extra). Raises ``KVTierError`` on any structural
    problem: bad magic, unknown version, checksum mismatch, short read."""
    if len(blob) < 8 or blob[:4] != _MAGIC:
        raise KVTierError("kv tier blob: bad magic")
    (hlen,) = struct.unpack("<I", blob[4:8])
    if len(blob) < 8 + hlen:
        raise KVTierError("kv tier blob: truncated header")
    try:
        header = json.loads(blob[8:8 + hlen])
    except ValueError as exc:
        raise KVTierError(f"kv tier blob: unparseable header: {exc}") from exc
    if header.get("version") != _VERSION:
        raise KVTierError(
            f"kv tier blob: version {header.get('version')!r} "
            f"(this build reads {_VERSION})"
        )
    # one writable copy of the payload: its arrays go straight into
    # torch.from_numpy at scatter, which wants writable memory
    payload = memoryview(bytearray(blob))[8 + hlen:]
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header.get("sha256"):
        raise KVTierError("kv tier blob: checksum mismatch")
    arrays: dict[str, np.ndarray] = {}
    off = 0
    for m in header.get("manifest", []):
        dt = host_dtype(m["dtype"])
        shape = tuple(int(s) for s in m["shape"])
        n = int(np.prod(shape)) * dt.itemsize
        if off + n > len(payload):
            raise KVTierError("kv tier blob: truncated payload")
        arrays[m["name"]] = np.frombuffer(
            payload, dtype=dt, count=n // dt.itemsize, offset=off
        ).reshape(shape)
        off += n
    entry = PageEntry(
        key=str(header.get("key", "")),
        n_tokens=int(header.get("n_tokens", 0)),
        page_size=int(header.get("page_size", 0)),
        fingerprint=dict(header.get("fingerprint") or {}),
        arrays=arrays,
        # absent on pre-reshard writers: reads as the canonical layout
        layout=dict(header["layout"]) if header.get("layout") else None,
    )
    return entry, dict(header.get("extra") or {})


# -- the store -------------------------------------------------------------


class KVTierStore:
    """Thread-safe two-rung LRU. The scheduler loop calls ``put``/
    ``fetch``/``drop``; the writer thread owns all disk I/O for
    demotions (fetches read inline, on the loop thread)."""

    def __init__(self, cfg: TierConfig | None = None):
        self.cfg = cfg or TierConfig.from_env()
        self._lock = threading.Lock()
        self._ram: OrderedDict[str, PageEntry] = OrderedDict()
        self._ram_bytes = 0
        self._pending: dict[str, PageEntry] = {}  # demoting, not yet on disk
        self._disk: OrderedDict[str, int] = OrderedDict()  # key -> nbytes
        self._disk_bytes = 0
        self._q: queue.Queue = queue.Queue()
        self._writer: threading.Thread | None = None
        # content-addressed (CDN) state: pin refcounts — one per live
        # session sharing the entry — guard budget eviction (an explicit
        # drop() still wins: pins protect against *pressure*, not intent);
        # the hit/store tallies drive the kv.dedup_ratio gauge
        self._pins: dict[str, int] = {}
        self._cas_hits = 0
        self._cas_stores = 0

    # -- paths / gauges ---------------------------------------------------

    def _path(self, key: str) -> str:
        name = hashlib.sha256(key.encode("utf-8")).hexdigest()[:40]
        return os.path.join(self.cfg.disk_dir, f"{name}.fkv")

    def _gauges_locked(self) -> None:
        METRICS.gauge("kv.tier_bytes_ram", self._ram_bytes)
        METRICS.gauge("kv.tier_bytes_disk", self._disk_bytes)
        METRICS.gauge(
            "kv.tier_entries",
            len(self._ram) + len(self._pending) + len(self._disk),
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "ram_entries": len(self._ram),
                "ram_bytes": self._ram_bytes,
                "pending": len(self._pending),
                "disk_entries": len(self._disk),
                "disk_bytes": self._disk_bytes,
                "pinned_keys": len(self._pins),
                "cas_dedup_hits": self._cas_hits,
                "cas_stores": self._cas_stores,
            }

    # -- writer thread ----------------------------------------------------

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="fei-kv-tier-writer",
                daemon=True,
            )
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:  # flush marker
                    continue
                self._demote(item)
            except Exception as exc:  # noqa: BLE001 — a failed demotion
                # only costs the fast resume; replay still covers
                log.warning("kv tier demotion failed: %r", exc)
                with self._lock:
                    self._pending.pop(item, None)
                    METRICS.incr("kv.spill_failures")
                    self._gauges_locked()
            finally:
                self._q.task_done()

    def flush(self, timeout_s: float = 30.0) -> None:
        """Block until every queued demotion landed (tests/bench use this
        to make the async tier deterministic)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and self._q.unfinished_tasks == 0:
                    return
            time.sleep(0.005)

    def _demote(self, key: str) -> None:
        with self._lock:
            entry = self._pending.get(key)
        if entry is None:  # dropped while queued
            return
        os.makedirs(self.cfg.disk_dir, exist_ok=True)
        blob = pack_entry(entry)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # atomic like checkpoint snapshots
            f.write(blob)
        os.replace(tmp, path)
        with self._lock:
            if key not in self._pending:  # dropped mid-write: undo
                try:
                    os.remove(path)
                except OSError:
                    pass
                return
            del self._pending[key]
            self._disk[key] = len(blob)
            self._disk_bytes += len(blob)
            METRICS.incr("kv.demotions")
            evict = []
            while self._disk_bytes > self.cfg.disk_bytes and len(self._disk) > 1:
                # coldest UNPINNED file goes first; when only pinned
                # entries remain the rung runs over budget rather than
                # deleting bytes live sessions still rendezvous on
                k = next(
                    (c for c in self._disk if self._pins.get(c, 0) <= 0),
                    None,
                )
                if k is None:
                    break
                nb = self._disk.pop(k)
                self._disk_bytes -= nb
                evict.append(k)
                METRICS.incr("kv.evictions")
            self._gauges_locked()
        for k in evict:
            try:
                os.remove(self._path(k))
            except OSError:
                pass

    # -- public API -------------------------------------------------------

    def put(self, key: str, entry: PageEntry) -> None:
        """Land an entry in the RAM rung; demote/evict LRU past budgets.
        Raises on injected spill faults (the caller counts and moves on —
        preemption itself must never depend on the tier)."""
        FAULTS.check("kv.spill", key=key)
        with self._lock:
            old = self._ram.pop(key, None)
            if old is not None:
                self._ram_bytes -= old.nbytes
            self._drop_cold_locked(key)
            self._ram[key] = entry
            self._ram_bytes += entry.nbytes
            demote: list[str] = []
            drop: list[str] = []
            while self._ram_bytes > self.cfg.ram_bytes and len(self._ram) > 1:
                # coldest entry first, but a pinned entry only moves to a
                # rung it stays fetchable from: with disk on it demotes
                # like anything else; RAM-only mode would LOSE it, so the
                # scan skips pinned keys (and the rung runs over budget
                # when nothing unpinned remains)
                k = next(
                    (
                        c for c in self._ram
                        if c != key
                        and (self.cfg.disk_enabled
                             or self._pins.get(c, 0) <= 0)
                    ),
                    None,
                )
                if k is None:
                    break
                e = self._ram.pop(k)
                self._ram_bytes -= e.nbytes
                if self.cfg.disk_enabled:
                    self._pending[k] = e
                    demote.append(k)
                else:
                    drop.append(k)
                    METRICS.incr("kv.evictions")
            self._gauges_locked()
        if demote:
            self._ensure_writer()
            for k in demote:
                self._q.put(k)

    def _drop_cold_locked(self, key: str) -> None:
        """Forget any colder copy of ``key`` (pending/disk) — a fresh put
        supersedes it and a later fetch must not see stale pages."""
        self._pending.pop(key, None)
        nb = self._disk.pop(key, None)
        if nb is not None:
            self._disk_bytes -= nb
            try:
                os.remove(self._path(key))
            except OSError:
                pass

    def fetch(self, key: str) -> PageEntry | None:
        """The entry for ``key``, or None on a clean miss. Raises
        ``KVTierError``/``OSError``/``TimeoutError`` on a corrupt entry,
        an unreadable file, or an injected hang — callers treat ANY
        exception as "fall back to token replay"."""
        FAULTS.check("kv.fetch", key=key)
        with self._lock:
            entry = self._ram.get(key)
            if entry is not None:
                self._ram.move_to_end(key)
                return entry
            entry = self._pending.get(key)
            if entry is not None:
                return entry
            on_disk = key in self._disk
        if not on_disk:
            METRICS.incr("kv.fetch_misses")
            return None
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            entry, _ = unpack_entry(blob)
        except KVTierError:
            # fail closed: a corrupt file must never be served twice
            METRICS.incr("kv.fetch_corrupt")
            with self._lock:
                nb = self._disk.pop(key, None)
                if nb is not None:
                    self._disk_bytes -= nb
                self._gauges_locked()
            try:
                os.remove(path)
            except OSError:
                pass
            raise
        except OSError:
            METRICS.incr("kv.fetch_corrupt")
            with self._lock:
                nb = self._disk.pop(key, None)
                if nb is not None:
                    self._disk_bytes -= nb
                self._gauges_locked()
            raise
        with self._lock:
            if key in self._disk:
                self._disk.move_to_end(key)
        return entry

    def drop(self, key: str) -> None:
        """Forget ``key`` at every rung (sequence finished or its entry
        went stale). Deliberately ignores pins: they guard against
        budget pressure, not against a caller that KNOWS the entry is
        stale/poisoned."""
        with self._lock:
            e = self._ram.pop(key, None)
            if e is not None:
                self._ram_bytes -= e.nbytes
            self._drop_cold_locked(key)
            self._gauges_locked()

    # -- content-addressed (CDN) API ---------------------------------------

    def pin(self, key: str) -> None:
        """Take one eviction-protection reference on ``key`` (a live
        session shares its bytes). Pinning an absent key is legal — the
        pin guards whatever lands under the key later."""
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: str) -> None:
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n

    def pin_count(self, key: str) -> int:
        with self._lock:
            return self._pins.get(key, 0)

    def contains(self, key: str) -> bool:
        """Presence probe across every rung; no LRU touch, no I/O."""
        with self._lock:
            return (
                key in self._ram
                or key in self._pending
                or key in self._disk
            )

    def put_if_absent(self, key: str, make_entry) -> bool:
        """The dedup rendezvous: store ``make_entry()`` under ``key``
        unless any rung already holds it — N publishers of the same
        content, exactly one copy. ``make_entry`` may be a ``PageEntry``
        or a zero-arg factory; the factory only runs on absence, so a
        duplicate publish never pays the device→host gather. True when
        this call stored."""
        with self._lock:
            if (
                key in self._ram
                or key in self._pending
                or key in self._disk
            ):
                if key in self._ram:
                    self._ram.move_to_end(key)
                self._cas_hits += 1
                METRICS.incr("kv.cas_dedup_hits")
                self._dedup_gauge_locked()
                return False
        entry = make_entry() if callable(make_entry) else make_entry
        self.put(key, entry)
        with self._lock:
            self._cas_stores += 1
            METRICS.incr("kv.cas_stores")
            self._dedup_gauge_locked()
        return True

    def _dedup_gauge_locked(self) -> None:
        total = self._cas_hits + self._cas_stores
        if total:
            METRICS.gauge("kv.dedup_ratio", self._cas_hits / total)

    def advertised(self, limit: int = 64) -> list[str]:
        """Content-addressed keys this store can serve, hottest first
        (RAM in MRU order, then in-flight demotions, then disk MRU) —
        the ``GET /kv/prefix`` payload peers and the pre-warm pass read."""
        from fei_tpu_torch.kv.content import is_cas_key

        out: list[str] = []
        seen: set[str] = set()
        with self._lock:
            for rung in (
                reversed(self._ram), iter(self._pending),
                reversed(self._disk),
            ):
                for k in rung:
                    if is_cas_key(k) and k not in seen:
                        seen.add(k)
                        out.append(k)
        return out[: max(0, int(limit))]

    def clear(self) -> None:
        with self._lock:
            keys = list(self._disk)
            self._ram.clear()
            self._pending.clear()
            self._disk.clear()
            self._pins.clear()
            self._ram_bytes = self._disk_bytes = 0
            self._gauges_locked()
        for k in keys:
            try:
                os.remove(self._path(k))
            except OSError:
                pass
