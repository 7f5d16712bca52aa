"""Crash-consistent per-request session journal, a write-ahead log (a
copy of fei_tpu/engine/journal.py; the two packages read and write the
same files).

Drain snapshots need a live, willing engine; the journal makes a HARD
failure (kill -9, device loss, OOM) a scheduling event too: the
scheduler appends an admission record when a request is accepted, a
token record for every token it actually *delivers* to the client
(carrying the slot's threefry key after that step, so seeded sampling
re-enters bit-identically), and a terminal record when the stream ends.
On the next boot, ``engine.warm_restart()`` scans the journal, truncates
at the first torn record, and re-admits every unfinished session through
the same ``submit(_restore=...)`` path the drain snapshots use — the
delivered tokens are teacher-forced back into the KV cache and re-emitted
to the new waiter, so the concatenated stream equals the uninterrupted
one.

On-disk format — append-only segments ``journal-<n>.wal``, each a
sequence of self-contained records::

    [u32 length][u32 crc32(payload)][payload: UTF-8 JSON]

Recovery reads segments in index order and stops at the first record
whose header is short, whose payload is short, or whose CRC does not
match — everything after a torn record is discarded, so a crash mid-
append can never resurrect a phantom token, and every fully-appended
(committed) record survives. Record payloads:

- ``{"t": "admit", "rid", "prompt_ids", "gen", ...}`` — request
  accepted (a resumed admission carries its already-delivered
  ``generated``/``resume_key`` so recovery composes across crashes)
- ``{"t": "tok", "rid", "tok", "key"}`` — one token DELIVERED to the
  client; ``key`` is the per-slot PRNG state after sampling it. The
  port's first token record of a request also carries ``route``
  ("dense" or "chunked", the admission route its prompt took), which the
  JAX package's reader ignores; a session without one resumes through
  the chunks, as the JAX package resumes every session.
- ``{"t": "end", "rid", "reason"}`` — stream finished/failed/cancelled

Appends go through a background writer thread so the decode hot path
never blocks on disk. Durability knob ``FEI_TPU_JOURNAL_SYNC``:

- ``off``    — never fsync (page cache only; survives process death,
  not host power loss)
- ``batch``  — fsync once per drained write batch (default: bounds the
  loss window to in-flight batches at negligible steady-state cost)
- ``always`` — fsync after every record (every delivered token is
  durable before the next append; the zero-loss chaos stages run here)

Segment rotation always fsyncs the finished segment and the directory
(via the checkpoint fsync helpers) regardless of mode — a completed
segment is history, not a loss window.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
import zlib

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.utils.fsync import fsync_dir
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("journal")

_HDR = struct.Struct("<II")
_SEG_PREFIX = "journal-"
_SEG_SUFFIX = ".wal"
# corrupt length fields must not drive absurd allocations: no sane
# record (prompt + config JSON) approaches this
_MAX_RECORD = 64 << 20

SYNC_MODES = ("off", "batch", "always")


def _seg_index(name: str) -> int | None:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def _seg_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(index, path) for every journal segment in ``directory``, sorted."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    segs = []
    for n in names:
        i = _seg_index(n)
        if i is not None:
            segs.append((i, os.path.join(directory, n)))
    segs.sort()
    return segs


def encode_record(payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    return _HDR.pack(len(body), zlib.crc32(body)) + body


def iter_records(blob: bytes):
    """Yield decoded payload dicts from a segment byte string, stopping
    at the first torn record (:func:`scan_segment` also says whether
    the tail was torn)."""
    for rec, _ in scan_segment(blob)[0]:
        yield rec


def scan_segment(blob: bytes) -> tuple[list[tuple[dict, int]], bool]:
    """Decode ``blob`` into ``([(payload, end_offset), ...], torn)``.

    ``end_offset`` is the byte offset one past the record — the exact
    truncation frontier recovery keeps. ``torn`` is True when the tail
    of the segment held a short or CRC-mismatched record."""
    out: list[tuple[dict, int]] = []
    off = 0
    n = len(blob)
    while off < n:
        if off + _HDR.size > n:
            return out, True
        length, crc = _HDR.unpack_from(blob, off)
        if length > _MAX_RECORD or off + _HDR.size + length > n:
            return out, True
        body = blob[off + _HDR.size:off + _HDR.size + length]
        if zlib.crc32(body) != crc:
            return out, True
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return out, True
        off += _HDR.size + length
        out.append((payload, off))
    return out, False


def recover(directory: str) -> tuple[list[dict], int]:
    """Scan ``directory`` and rebuild unfinished sessions.

    Returns ``(sessions, torn_records)``. Each session is shaped for
    ``PagedScheduler.submit(..., _restore=session)``: ``rid``,
    ``prompt_ids``, ``gen`` (config dict), ``generated`` (every token
    the dead process committed as delivered), ``resume_key`` (the PRNG
    state after the last committed token, or None), plus whatever
    tenant/priority/deadline/mesh fields the admission carried.

    Recovery truncates at the FIRST torn record: a torn tail in segment
    k discards the rest of k and every later segment (later segments
    were written after the torn point; trusting them would reorder
    history). A committed (fully appended, CRC-valid) token is never
    lost; a half-appended one is never resurrected.
    """
    sessions: dict[str, dict] = {}
    done: set[str] = set()
    torn = 0
    for _, path in list_segments(directory):
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as exc:
            log.warning("journal: unreadable segment %s (%r)", path, exc)
            torn += 1
            break
        records, seg_torn = scan_segment(blob)
        for rec, _ in records:
            kind = rec.get("t")
            rid = rec.get("rid")
            if kind == "admit" and rid:
                sess = {
                    k: v for k, v in rec.items() if k not in ("t",)
                }
                sess.setdefault("generated", [])
                sess.setdefault("resume_key", None)
                sessions[rid] = sess
            elif kind == "tok" and rid in sessions:
                sessions[rid]["generated"].append(int(rec["tok"]))
                if rec.get("key") is not None:
                    sessions[rid]["resume_key"] = rec["key"]
                if rec.get("route") is not None:
                    sessions[rid]["route"] = rec["route"]
            elif kind == "end" and rid:
                done.add(rid)
                sessions.pop(rid, None)
        if seg_torn:
            torn += 1
            break
    if torn:
        METRICS.incr("journal.torn_records", torn)
    out = [s for rid, s in sessions.items() if rid not in done]
    return out, torn


class SessionJournal:
    """Append-only WAL with a background writer thread.

    All public append methods (:meth:`admit`, :meth:`token`,
    :meth:`finish`) enqueue and return immediately — the scheduler's
    delivery path never waits on disk. :meth:`flush` is the barrier
    (drain queue + force an fsync) tests and graceful shutdown use.
    A writer-thread I/O failure disables the journal for the process
    lifetime (serving continues; crash coverage degrades to the drain
    snapshots) rather than poisoning the decode loop.
    """

    def __init__(self, directory: str, sync: str = "batch",
                 segment_bytes: int = 4 << 20):
        if sync not in SYNC_MODES:
            raise ValueError(
                f"FEI_TPU_JOURNAL_SYNC must be one of {SYNC_MODES}, "
                f"got {sync!r}"
            )
        self.directory = directory
        self.sync = sync
        self.segment_bytes = int(segment_bytes)
        os.makedirs(directory, exist_ok=True)
        existing = list_segments(directory)
        self._live_index = (existing[-1][0] + 1) if existing else 1
        self._fh = open(  # noqa: SIM115 — lifetime spans the journal
            os.path.join(directory, _seg_name(self._live_index)), "ab"
        )
        self._written = 0
        self._broken = False
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._writer = threading.Thread(
            target=self._run, name="fei-journal", daemon=True
        )
        self._writer.start()

    # ------------------------------------------------------------ appends

    def admit(self, rec: dict) -> None:
        """Journal an accepted request. ``rec`` must carry ``rid``,
        ``prompt_ids`` and ``gen``; a resumed admission also carries
        ``generated``/``resume_key`` so recovery composes across
        repeated crashes."""
        self._put({"t": "admit", **rec})

    def token(self, rid: str, tok: int, key=None, extra: dict | None = None) -> None:
        """Journal one DELIVERED token. ``key`` is the slot's PRNG
        state after sampling it ([2] uint32 as a list), or None;
        ``extra`` adds fields to the record (the first token's route)."""
        rec = {"t": "tok", "rid": rid, "tok": int(tok), "key": key}
        if extra:
            rec.update(extra)
        self._put(rec)

    def finish(self, rid: str, reason: str = "completed") -> None:
        self._put({"t": "end", "rid": rid, "reason": reason})

    def _put(self, payload: dict) -> None:
        if self._broken or self._closed:
            return
        self._q.put(("rec", payload))

    # ----------------------------------------------------------- barriers

    def flush(self, timeout: float = 5.0) -> bool:
        """Drain the queue and force an fsync; True when durable."""
        if self._broken:
            return False
        ev = threading.Event()
        self._q.put(("flush", ev))
        return ev.wait(timeout)

    def close(self, timeout: float = 5.0) -> None:
        if self._closed:
            return
        self._closed = True
        ev = threading.Event()
        self._q.put(("close", ev))
        ev.wait(timeout)

    # ----------------------------------------------------------- recovery

    def recover_and_clear(self) -> tuple[list[dict], int]:
        """Scan every segment OLDER than this instance's live one,
        delete them, and return ``(sessions, torn)``.

        Deletion happens BEFORE the caller re-admits (the same
        at-most-once rule as ``clear_request_snapshots``): a crash
        during re-admission loses the re-admitted sessions rather than
        double-admitting them — and the re-admissions are themselves
        journaled into the live segment, so the window is one crash
        landing inside warm_restart itself."""
        old = [
            (i, p) for i, p in list_segments(self.directory)
            if i < self._live_index
        ]
        if not old:
            return [], 0
        sessions, torn = recover(self.directory)
        for _, path in old:
            try:
                os.unlink(path)
            except OSError:
                pass
        fsync_dir(self.directory)
        return sessions, torn

    # -------------------------------------------------------- writer loop

    def _run(self) -> None:
        while True:
            item = self._q.get()
            batch = [item]
            # coalesce whatever queued up behind it: one write + (in
            # batch mode) one fsync per drain, not per token
            while True:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                stop = self._drain(batch)
            except (OSError, TimeoutError) as exc:
                log.warning(
                    "journal: writer failed (%r); journaling disabled — "
                    "crash coverage degrades to drain snapshots", exc,
                )
                self._broken = True
                for kind, arg in batch:
                    if kind in ("flush", "close"):
                        arg.set()
                stop = any(k == "close" for k, _ in batch)
            if stop:
                return

    def _drain(self, batch: list) -> bool:
        events, stop, dirty = [], False, False
        for kind, arg in batch:
            if kind == "rec":
                if not self._broken:
                    self._append(arg)
                    dirty = True
                    if self.sync == "always":
                        self._fsync()
                        dirty = False
            elif kind == "flush":
                events.append(arg)
            elif kind == "close":
                events.append(arg)
                stop = True
        if events and dirty:
            self._fsync()
            dirty = False
        elif dirty and self.sync == "batch":
            self._fsync()
        for ev in events:
            ev.set()
        if stop:
            try:
                self._fh.close()
            except OSError:
                pass
        return stop

    def _append(self, payload: dict) -> None:
        FAULTS.check("journal.append")
        blob = encode_record(payload)
        if self._written and self._written + len(blob) > self.segment_bytes:
            self._rotate()
        self._fh.write(blob)
        self._fh.flush()
        self._written += len(blob)
        METRICS.incr("journal.appends")
        METRICS.incr("journal.bytes", len(blob))

    def _fsync(self) -> None:
        FAULTS.check("journal.fsync")
        os.fsync(self._fh.fileno())
        METRICS.incr("journal.fsyncs")

    def _rotate(self) -> None:
        """Seal the live segment (fsync file + dir regardless of mode —
        a finished segment is history, not a loss window) and open the
        next one."""
        try:
            os.fsync(self._fh.fileno())
            METRICS.incr("journal.fsyncs")
        finally:
            self._fh.close()
        self._live_index += 1
        path = os.path.join(self.directory, _seg_name(self._live_index))
        self._fh = open(path, "ab")  # noqa: SIM115
        self._written = 0
        fsync_dir(self.directory)


def deadline_epoch(remaining_s: float | None) -> float | None:
    """Wall-clock absolute deadline for an admit record (monotonic
    clocks do not survive the process, wall clocks do)."""
    if remaining_s is None:
        return None
    return time.time() + float(remaining_s)


def deadline_remaining(epoch: float | None) -> float | None:
    """Remaining budget at recovery; <= 0 means the session expired
    while the process was down."""
    if epoch is None:
        return None
    return float(epoch) - time.time()
