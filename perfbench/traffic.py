"""The one general generator of traffic.  A mix is a data file,
``traffic/<mix>.json``, naming its driver (``swap``, ``prefill`` or
``decode``) and that driver's parameters.  The seed draws the contents
of the work (token ids, payload bytes) and never its lengths, counts or
order: every seed gives a run the same work."""
from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

#: stream numbers that keep the seed's draws for different uses apart
STREAM_WEIGHTS, STREAM_TOKENS, STREAM_PAYLOAD, STREAM_SAMPLE = 0, 1, 2, 3


def load(mix: str) -> dict:
    return json.loads((HERE / "traffic" / f"{mix}.json").read_text())


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A seed of its own for each (stream, index) of a run's seed."""
    return (seed * 1_000_003 + stream * 7_919 + index) % (2 ** 63)


def prefill_batches(mix: dict):
    """The cycle of (prompt length, rows) a prefill mix sends, in order:
    each batch holds ``tokens_per_batch`` tokens of one length."""
    out = []
    for L in mix["lengths"]:
        B, rem = divmod(mix["tokens_per_batch"], L)
        if rem or B < 1:
            raise ValueError(f"{L} does not divide {mix['tokens_per_batch']}")
        out.append((L, B))
    return out


def tokens(seed: int, index: int, shape, vocab: int, device) -> torch.Tensor:
    """Token ids of batch ``index`` of a run: uniform over the model's
    own vocabulary, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, STREAM_TOKENS, index))
    return torch.randint(0, vocab, tuple(shape), generator=gen,
                         device=device)


def payload(seed: int, tenant: int, nbytes: int, device) -> torch.Tensor:
    """One tenant's checkpoint bytes, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, STREAM_PAYLOAD, tenant))
    return torch.randint(0, 256, (nbytes,), generator=gen,
                         dtype=torch.uint8, device=device)


def swap_tenant(mix: dict, n: int) -> int:
    """The tenant of request ``n`` of a swap mix."""
    if mix["order"] != "round_robin":
        raise ValueError(mix["order"])
    return n % mix["tenants"]
