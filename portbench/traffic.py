"""Traffic: one general generator, driven by a mix's parameter file.

A mix file (``traffic/<name>.json``) names a ``kind`` and its numbers:

- ``closed_chat``: ``clients`` users, each sending its next request as soon
  as the last one finished; every prompt is fresh random ids (no sharing).

A length is lognormal with the ``mean`` and ``std`` the mix gives (the
published statistics of a trace), rounded and held to at least ``min``
and, where the mix gives one, at most ``max``. To keep seeds from changing
the amount of work, every seed gets the same sizes: each quantity is a
fixed grid of ``POOL`` quantiles of its distribution, and the seed only
shuffles its order and draws the token ids.

Warm start: the first request of each client is cut to a uniform share of
its drawn length, so the load is near its steady mix when the measured
window opens after the cell's ``ramp_s`` seconds.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist

POOL = 512  # quantiles per quantity
FIRST_ID = 3  # ids 0-2 are pad/bos/eos in the configurations' tokenizers
MIN_BUCKET = 16  # the program's smallest dense prefill bucket


def lognormal(mean: float, std: float) -> tuple[float, float]:
    """(mu, sigma) of the lognormal with this mean and standard deviation."""
    s2 = math.log1p((std / mean) ** 2)
    return math.log(mean) - s2 / 2, math.sqrt(s2)


def quantile_grid(spec: dict, n: int = POOL) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of the lognormal."""
    z = NormalDist()
    mu, sigma = lognormal(spec["mean"], spec["std"])
    hi = spec.get("max", math.inf)
    return [int(min(hi, max(spec["min"], round(math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))))))
            for i in range(n)]


def uniform_grid(lo: float, hi: float, n: int = POOL) -> list[float]:
    return [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]


class Deck:
    """A shuffled grid, dealt in order and reshuffled when used up."""

    def __init__(self, values: list, rng: random.Random):
        self.values, self.rng, self.i = list(values), rng, len(values)

    def deal(self):
        if self.i == len(self.values):
            self.rng.shuffle(self.values)
            self.i = 0
        self.i += 1
        return self.values[self.i - 1]


@dataclass
class Request:
    prompt: list[int]
    max_new: int
    delay_s: float  # wait after the client's previous request ended


class ClosedChat:
    def __init__(self, p: dict, seed: int, vocab: int):
        self.p = p
        self.rng = random.Random(seed)
        self.vocab = vocab
        self.prompt_grid = quantile_grid(p["prompt"])
        self.prompts = Deck(self.prompt_grid, self.rng)
        self.outputs = Deck(quantile_grid(p["output"]), self.rng)
        self.shares = Deck(uniform_grid(0.0, 1.0), self.rng)
        self.clients = p["clients"]

    def ids(self, n: int) -> list[int]:
        return [self.rng.randrange(FIRST_ID, self.vocab) for _ in range(n)]

    def next(self, client: int, prev: tuple | None) -> Request:
        out = self.outputs.deal()
        if prev is None:  # warm start: the rest of a request already under way
            out = max(1, math.ceil(self.shares.deal() * out))
        return Request(self.ids(self.prompts.deal()), out, 0.0)

    def warm_lengths(self, chunk: int) -> list[int]:
        """One prompt length in each dense prefill bucket (powers of two
        from ``MIN_BUCKET``) that the mix's prompts up to ``chunk`` fall
        in, and the shortest prompt over ``chunk`` where there is one (the
        program's chunked admission, whose chunks are ``chunk`` tokens and
        a remainder)."""
        lo, hi = min(self.prompt_grid), max(self.prompt_grid)
        out, b = {lo}, MIN_BUCKET
        while b < min(hi, chunk):
            out.add(min(b, hi))
            b *= 2
        out.add(min(hi, chunk, b))
        longer = [n for n in self.prompt_grid if n > chunk]
        if longer:
            out.add(min(longer))
        return sorted(out)


KINDS = {"closed_chat": ClosedChat}


def make(p: dict, seed: int, vocab: int):
    return KINDS[p["kind"]](p, seed, vocab)
