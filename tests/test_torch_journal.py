"""The port's session journal (fei_tpu_torch/engine/journal.py), the cases
of tests/test_journal.py run against it, and the file format held across
packages:

- framing: every fully appended (CRC-valid) record survives and every
  half-appended one is discarded, at every truncation point and every
  corrupted byte;
- recovery folds admit/tok/end records into sessions (composing across
  resumed admissions and segments; a torn segment discards every later
  one), and the port's first-token ``route`` field folds in too;
- the writer thread rotates segments, honours the sync modes, and an I/O
  fault disables journaling instead of raising;
- a journal the JAX package's ``SessionJournal`` writes recovers in the
  port to the same sessions, and one the port writes recovers the same
  way in the JAX package (bytes identical for the same records).

Host code only: no engine, no device. No test sleeps; every journal is
closed.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import os
import shutil
import struct

import pytest

from fei_tpu.engine import journal as jax_journal
from fei_tpu_torch.engine import journal as pt_journal
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.journal import (
    SessionJournal,
    deadline_epoch,
    deadline_remaining,
    encode_record,
    list_segments,
    recover,
    scan_segment,
)
from fei_tpu_torch.utils.metrics import METRICS


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


def _records(n_toks: int = 6) -> list[dict]:
    recs = [{"t": "admit", "rid": "r1", "prompt_ids": [1, 2, 3],
             "gen": {"max_new_tokens": 8, "temperature": 0.0}}]
    for i in range(n_toks):
        recs.append({"t": "tok", "rid": "r1", "tok": 100 + i, "key": [i, i + 1]})
    return recs


def _blob(recs: list[dict]) -> tuple[bytes, list[int]]:
    blob, ends = b"", []
    for r in recs:
        blob += encode_record(r)
        ends.append(len(blob))
    return blob, ends


def _write_seg(d: str, index: int, recs: list[dict], tail: bytes = b"") -> None:
    blob = b"".join(encode_record(r) for r in recs) + tail
    with open(os.path.join(d, f"journal-{index:08d}.wal"), "wb") as f:
        f.write(blob)


# -- framing ------------------------------------------------------------------


def test_framing_roundtrip_and_bytes_equal_reference():
    recs = _records()
    blob, ends = _blob(recs)
    decoded, torn = scan_segment(blob)
    assert not torn
    assert [r for r, _ in decoded] == recs
    assert [off for _, off in decoded] == ends
    assert blob == b"".join(jax_journal.encode_record(r) for r in recs)
    assert scan_segment(b"") == ([], False)


def test_truncation_at_every_byte():
    """For EVERY prefix length exactly the records fully inside it decode,
    and the torn flag is set iff the cut landed inside a record."""
    recs = _records()
    blob, ends = _blob(recs)
    boundaries = {0, *ends}
    for cut in range(len(blob) + 1):
        decoded, torn = scan_segment(blob[:cut])
        assert [r for r, _ in decoded] == [r for r, e in zip(recs, ends) if e <= cut], cut
        assert torn == (cut not in boundaries), cut


def test_corruption_at_every_byte():
    """Flipping any byte tears the record containing it: every record
    before it survives, nothing at or after it decodes."""
    recs = _records()
    blob, ends = _blob(recs)
    starts = [0, *ends[:-1]]
    for pos in range(len(blob)):
        owner = max(i for i, s in enumerate(starts) if s <= pos)
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        decoded, torn = scan_segment(bytes(bad))
        assert torn, pos
        assert [r for r, _ in decoded] == recs[:owner], pos


def test_absurd_length_field_is_torn():
    blob = struct.pack("<II", (64 << 20) + 1, 0) + b"x" * 64
    assert scan_segment(blob) == ([], True)


# -- recovery -----------------------------------------------------------------


RECOVER_CASES = {
    # segments (index -> records, tail), expected generated, key, torn
    "admit_toks_fold": ({1: (_records(3), b"")}, [100, 101, 102], [2, 3], 0),
    "resumed_admission_composes": (
        {1: ([{"t": "admit", "rid": "r1", "prompt_ids": [1], "gen": {},
               "generated": [7, 8], "resume_key": [40, 41]},
              {"t": "tok", "rid": "r1", "tok": 9, "key": [50, 51]}], b"")},
        [7, 8, 9], [50, 51], 0),
    "null_key_keeps_last_key": (
        {1: ([{"t": "admit", "rid": "r1", "prompt_ids": [1], "gen": {}},
              {"t": "tok", "rid": "r1", "tok": 5, "key": [10, 11]},
              {"t": "tok", "rid": "r1", "tok": 6, "key": None}], b"")},
        [5, 6], [10, 11], 0),
    "torn_segment_discards_later_segments": (
        {1: (_records(2), b"\x07garbage"),
         2: ([{"t": "tok", "rid": "r1", "tok": 999, "key": None}], b"")},
        [100, 101], [1, 2], 1),
    "multi_segment_composition": (
        {1: (_records(2), b""),
         2: ([{"t": "tok", "rid": "r1", "tok": 102, "key": [9, 9]}], b"")},
        [100, 101, 102], [9, 9], 0),
}


@pytest.mark.parametrize("case", list(RECOVER_CASES))
def test_recover(tmp_path, case):
    segs, generated, key, want_torn = RECOVER_CASES[case]
    for index, (recs, tail) in segs.items():
        _write_seg(str(tmp_path), index, recs, tail)
    sessions, torn = recover(str(tmp_path))
    assert torn == want_torn
    assert len(sessions) == 1 and sessions[0]["rid"] == "r1"
    assert sessions[0]["generated"] == generated
    assert sessions[0]["resume_key"] == key
    # the JAX package's reader folds the same files the same way
    assert jax_journal.recover(str(tmp_path)) == (sessions, torn)


def test_terminal_retires_session(tmp_path):
    _write_seg(str(tmp_path), 1, _records(2) + [{"t": "end", "rid": "r1",
                                                 "reason": "completed"}])
    assert recover(str(tmp_path)) == ([], 0)


def test_route_folds_from_first_token(tmp_path):
    """The port's first token record names the admission route; the JAX
    package's reader keeps the session and ignores the field."""
    recs = [{"t": "admit", "rid": "r1", "prompt_ids": [1], "gen": {}},
            {"t": "tok", "rid": "r1", "tok": 5, "key": [1, 2], "route": "dense"},
            {"t": "tok", "rid": "r1", "tok": 6, "key": [3, 4]}]
    _write_seg(str(tmp_path), 1, recs)
    sessions, _ = recover(str(tmp_path))
    assert sessions[0]["route"] == "dense"
    theirs, _ = jax_journal.recover(str(tmp_path))
    assert "route" not in theirs[0]
    assert theirs[0]["generated"] == sessions[0]["generated"] == [5, 6]


# -- the writer ---------------------------------------------------------------


def _write_sessions(j) -> None:
    j.admit({"rid": "done", "prompt_ids": [1], "gen": {}})
    j.token("done", 11, [1, 2])
    j.finish("done", "completed")
    j.admit({"rid": "live", "prompt_ids": [2], "gen": {"temperature": 0.8, "seed": 3}})
    j.token("live", 21, [3, 4])
    j.token("live", 22, [5, 6])
    assert j.flush()
    j.close()


@pytest.mark.parametrize("writer, reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_write_then_recover(tmp_path, writer, reader):
    """A journal either package writes recovers in either to the same
    sessions, and recovery consumes the segments (at-most-once)."""
    d = str(tmp_path)
    _write_sessions({"port": SessionJournal, "jax": jax_journal.SessionJournal}[writer](d))
    j2 = {"port": SessionJournal, "jax": jax_journal.SessionJournal}[reader](d, sync="off")
    sessions, torn = j2.recover_and_clear()
    assert torn == 0
    assert [s["rid"] for s in sessions] == ["live"]
    assert sessions[0]["generated"] == [21, 22]
    assert sessions[0]["resume_key"] == [5, 6]
    assert sessions[0]["gen"] == {"temperature": 0.8, "seed": 3}
    assert j2.recover_and_clear() == ([], 0)
    j2.close()


def test_port_segments_equal_reference_segments(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_sessions(SessionJournal(a))
    _write_sessions(jax_journal.SessionJournal(b))
    pa, pb = list_segments(a), jax_journal.list_segments(b)
    assert [os.path.basename(p) for _, p in pa] == [os.path.basename(p) for _, p in pb]
    for (_, x), (_, y) in zip(pa, pb):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()


def test_segment_rotation(tmp_path):
    d = str(tmp_path)
    j = SessionJournal(d, sync="off", segment_bytes=96)
    j.admit({"rid": "r", "prompt_ids": [1], "gen": {}})
    for i in range(20):
        j.token("r", i, [i, i])
    assert j.flush()
    assert len(list_segments(d)) > 1
    j.close()
    shutil.copytree(d, str(tmp_path / "copy"))
    j2 = SessionJournal(d)
    sessions, torn = j2.recover_and_clear()
    j2.close()
    assert torn == 0 and sessions[0]["generated"] == list(range(20))
    assert jax_journal.recover(str(tmp_path / "copy"))[0] == sessions


def test_sync_mode_validation(tmp_path):
    with pytest.raises(ValueError, match="FEI_TPU_JOURNAL_SYNC"):
        SessionJournal(str(tmp_path), sync="sometimes")


@pytest.mark.parametrize("sync, per_record", [("always", True), ("batch", False), ("off", False)])
def test_sync_modes(tmp_path, sync, per_record):
    """``always`` fsyncs after every record; ``batch`` once per drained
    batch; ``off`` only at the flush barrier."""
    j = SessionJournal(str(tmp_path), sync=sync)
    c0 = _counter("journal.fsyncs")
    for i in range(4):
        j.token("r", i)
    assert j.flush()
    n = _counter("journal.fsyncs") - c0
    assert n >= 4 if per_record else 1 <= n <= 5
    j.close()


def test_writer_fault_disables_not_raises(tmp_path):
    """A journal I/O failure degrades crash coverage, never serving: the
    writer flips the broken flag and every later append is a no-op."""
    j = SessionJournal(str(tmp_path), sync="off")
    FAULTS.arm("journal.append", "io", count=1)
    j.token("r", 1)
    j.flush()  # the barrier drains the failed batch
    assert j._broken
    j.token("r", 2)  # dropped, no exception
    assert j.flush() is False
    j.close()


def test_fresh_instance_opens_new_segment(tmp_path):
    d = str(tmp_path)
    j1 = SessionJournal(d)
    j1.admit({"rid": "r", "prompt_ids": [1], "gen": {}})
    j1.flush()
    j1.close()
    j2 = SessionJournal(d)
    assert j2._live_index > j1._live_index
    j2.close()


def test_deadlines():
    rem = deadline_remaining(deadline_epoch(5.0))
    assert 4.0 < rem <= 5.0
    assert deadline_epoch(None) is None and deadline_remaining(None) is None
    assert pt_journal.SYNC_MODES == jax_journal.SYNC_MODES
