"""The load generator: one thread plays every client of a closed loop.

A client submits a request to the scheduler (``PagedScheduler.submit``,
the call under ``stream``) and reads its tokens from the request's output
queue, the same queue ``stream`` drains. One thread serves every client: it
stamps each token on the host clock when it reaches the client, and
submits a client's next request when its last one ended and its think
time is over. Between rounds it sleeps on the queue of a request that is
decoding (the scheduler delivers every row's tokens of a scan in one
burst), at most ``WAIT_S``, so it takes the interpreter lock from the
scheduler's loop thread only when there is something to stamp; a token's
stamp is late by at most ``WAIT_S``. Each round it also reads ``probe``,
where one is given, and keeps the largest reading (the run's peak of the
program's pages in use).
"""

from __future__ import annotations

import numbers
import threading
import time
from dataclasses import dataclass, field

WAIT_S = 0.005
BURST_S = 0.02  # a scan's tokens all reach the clients within this


@dataclass
class Record:
    client: int
    prompt: list[int]
    max_new: int
    due: float  # when the client wanted to send it (host clock)
    seq: object | None = None  # the scheduler's request, once submitted
    stamps: list[float] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)
    error: str | None = None
    ended: float | None = None  # DONE, failed, or cancelled

    @property
    def finished(self) -> bool:
        return self.error is None and len(self.tokens) == self.max_new

    @property
    def ttft(self) -> float | None:
        return self.stamps[0] - self.due if self.stamps else None


class LoadGenerator:
    def __init__(self, scheduler, traffic, gen_config, probe=None):
        self.sched = scheduler
        self.traffic = traffic
        self.gen_config = gen_config  # max_new_tokens -> GenerationConfig
        self.records: list[Record] = []
        self.live: list[Record] = []
        self.waiting: list[Record] = []  # due later (think time)
        self.submitting = True
        self.probe = probe
        self.probe_peak = probe() if probe is not None else 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        now = time.perf_counter()
        for c in range(self.traffic.clients):
            self._plan(c, None, now)
        self._thread = threading.Thread(target=self._run, name="portbench-client", daemon=True)
        self._thread.start()

    def _plan(self, client: int, prev: tuple | None, now: float) -> None:
        req = self.traffic.next(client, prev)
        self.waiting.append(Record(client, req.prompt, req.max_new, now + req.delay_s))

    def _submit(self, r: Record) -> None:
        self.records.append(r)
        try:
            r.seq = self.sched.submit(r.prompt, self.gen_config(r.max_new))
        except Exception as exc:  # a refused request counts as failed
            r.error = f"{type(exc).__name__}: {exc}"
            r.ended = time.perf_counter()
            if self.submitting:
                self._plan(r.client, None, r.ended)
            return
        self.live.append(r)

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            if self.submitting and self.waiting:
                due = [r for r in self.waiting if r.due <= now]
                if due:
                    self.waiting = [r for r in self.waiting if r.due > now]
                    for r in due:
                        self._submit(r)
            ended = []
            for r in self.live:
                q = r.seq.out
                if not q.queue:
                    continue
                while q.queue:
                    item = q.get_nowait()
                    if isinstance(item, numbers.Integral):
                        r.tokens.append(int(item))
                        r.stamps.append(now)
                    else:
                        if isinstance(item, BaseException):
                            r.error = f"{type(item).__name__}: {item}"
                        ended.append(r)
                        break
            if self.probe is not None:
                self.probe_peak = max(self.probe_peak, self.probe())
            for r in ended:
                r.ended = now
                self.live.remove(r)
                if self.submitting:
                    self._plan(r.client, (r.prompt, r.tokens), now)
            self._wait(now)

    def _wait(self, now: float) -> None:
        timeout = WAIT_S
        if self.submitting and self.waiting:
            timeout = max(0.0, min(timeout, min(r.due for r in self.waiting) - now))
        decoding = next((r for r in self.live if r.stamps), None)
        if decoding is None:
            time.sleep(timeout)
            return
        q = decoding.seq.out
        with q.not_empty:
            if not q.queue:
                q.not_empty.wait(timeout)

    def next_burst(self, after: float) -> float:
        """Wait for the first delivery stamped after ``after`` and return
        a time just past its burst (a scan's tokens reach the clients
        together, within ``BURST_S``): a window that opens and closes so
        counts whole bursts."""
        while True:
            first = min((x for r in list(self.records) for x in r.stamps[-1:] if x > after),
                        default=None)
            if first is not None:
                time.sleep(max(0.0, first + BURST_S - time.perf_counter()))
                return first + BURST_S
            time.sleep(0.002)

    def stop_submitting(self) -> None:
        self.submitting = False

    def wait_first_tokens(self, since: float, until: float, timeout_s: float) -> None:
        """Wait until every request due in [since, until] has its first
        token or has ended, at most ``timeout_s``."""
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end:
            pending = [r for r in list(self.live) if since <= r.due <= until and not r.stamps]
            if not pending:
                return
            time.sleep(0.05)

    def close(self) -> None:
        """Cancel what is still running and stop the thread."""
        self.submitting = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("the load generator's thread did not stop")
        for r in self.live:
            self.sched.cancel(r.seq)
            r.ended = r.ended or time.perf_counter()
        self.sched = None  # the program's state goes with its engine
