"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests that finished in the window, drawn from the seed and always
holding the longest, goes through the plain reference
(``reference/model.py``) over its prompt and the tokens the program
served. At each served token the reference's logits give the gap by which
that token's logit lies below the reference's best there; the number
compared is the widest such gap (``max_logit_gap``). Greedy decoding that
agrees with the reference reads 0, and a token the program picked on a
near-tie reads a small gap. The limit, in the cell's workload file, lies
between the widest gap that sound runs of the program read over many
seeds and the least that the control reads (``control_gap``: the
reference computed a precision step lower, whose own first choice at the
same positions is judged the same way).
"""

from __future__ import annotations

import random

import torch

from portbench.reference.model import logits_at

SAMPLE_SALT = 0x5EED


def sample(records: list, seed: int, tokens: int) -> list:
    """The longest finished request, then others drawn from the seed, at
    most one a client while clients are left, until ``tokens`` served
    tokens are in the sample: a fault confined to some rows of the batch
    meets the sample on as many rows as the budget reaches."""
    done = sorted(records, key=lambda r: (len(r.prompt) + len(r.tokens), r.due))
    if not done:
        return []
    picked = [done.pop()]
    rng = random.Random(seed ^ SAMPLE_SALT)
    rng.shuffle(done)
    seen, fresh, rest = {picked[0].client}, [], []
    for r in done:
        (rest if r.client in seen else fresh).append(r)
        seen.add(r.client)
    for r in fresh + rest:
        if sum(len(x.tokens) for x in picked) >= tokens:
            break
        picked.append(r)
    return picked


def positions(r) -> tuple[list[int], list[int]]:
    """(the sequence the reference reads, the positions whose logits
    predict each served token)."""
    seq = list(r.prompt) + list(r.tokens[:-1])
    start = len(r.prompt) - 1
    return seq, list(range(start, start + len(r.tokens)))


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    chosen token."""
    return ref.max(dim=-1).values - ref.gather(-1, chosen[:, None])[:, 0]


def served_gaps(model, seed: int, picked: list, device) -> torch.Tensor:
    """The gap of every sampled served token, as one 1-D tensor."""
    seqs, rows = zip(*(positions(r) for r in picked))
    ref = logits_at(model, seed, list(seqs), list(rows), device)
    return torch.cat([gaps(x, torch.tensor(r.tokens, device=device)).cpu()
                      for x, r in zip(ref, picked)])


def control_gaps(model, seed: int, picked: list, device) -> torch.Tensor:
    """The control: the reference a precision step lower, put in the
    program's place at the same prompts and tokens; the gap of the token
    it puts first at each position."""
    seqs, rows = zip(*(positions(r) for r in picked))
    ref = logits_at(model, seed, list(seqs), list(rows), device)
    low = logits_at(model, seed, list(seqs), list(rows), device, precision="control")
    return torch.cat([gaps(x, y.argmax(dim=-1)).cpu() for x, y in zip(ref, low)])


# the numbers a cell may compare, each read from the gaps of its sample
NUMBERS = {
    "max_logit_gap": lambda g: float(g.max()),
    "mean_logit_gap": lambda g: float(g.mean()),
}


def numbers(g: torch.Tensor) -> dict[str, float]:
    return {name: fn(g) for name, fn in NUMBERS.items()}


def judge(read: dict[str, float], limits: dict[str, float]) -> tuple[list, bool]:
    """The cell's numbers, each as (name, value, limit), and whether every
    one is within its limit; a number with nothing read fails."""
    compared = [(name, read.get(name, float("inf")), lim) for name, lim in limits.items()]
    return compared, bool(read) and all(v <= lim for _, v, lim in compared)
