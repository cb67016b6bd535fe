"""The one traffic generator: a traffic file's parameters and a seed →
the run's requests.

The seed draws the sample path: every prompt length, output length and
gap between arrivals, and their order.  Each is drawn by stratified
sampling: N requests, one draw in each of N equal-probability strata of
its distribution, at a point within the stratum drawn from the seed, and
the N draws put in an order drawn from the seed.  So every seed serves the
same distribution closely (the longest prompts and the clusters of
arrivals in proportion) along a path of its own.  A window holds a few
dozen requests, and plain independent draws let the count of long prompts
alone swing the tails from seed to seed.

Arrivals are a Poisson process at ``rate_rps``, conditioned on its count:
the gaps are exponential, scaled so that the last request falls half a
mean gap before the window closes.  Request i is due at its offset from
the window's start, whatever the engine is doing (an open loop).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Req:
    index: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    offset_s: float             # due time after the window opens


def _strata(rng: np.random.Generator, n: int) -> np.ndarray:
    """One probability in each of n equal strata, in an order from ``rng``."""
    return rng.permutation((np.arange(n) + rng.random(n)) / n)


def _lognormal(p: Dict[str, Any], u: np.ndarray) -> np.ndarray:
    nd = NormalDist()
    mu = math.log(p["median"])
    q = [math.exp(mu + p["sigma"] * nd.inv_cdf(min(max(x, 1e-12), 1 - 1e-12))) for x in u]
    return np.clip(np.rint(q), p["min"], p["max"]).astype(np.int64)


def n_requests(traffic: Dict[str, Any], seconds: float,
               rate: Optional[float] = None) -> int:
    rate = traffic["rate_rps"] if rate is None else rate
    return max(1, int(round(rate * seconds)))


def make_requests(traffic: Dict[str, Any], seconds: float, seed: int, vocab: int,
                  rate: Optional[float] = None) -> List[Req]:
    """The run's requests in due order.  ``rate`` overrides the file's
    ``rate_rps`` (the knee sweep)."""
    if traffic["arrival"] != "poisson":
        raise ValueError(f"unknown arrival {traffic['arrival']!r}")
    n = n_requests(traffic, seconds, rate)
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    prompts = _lognormal(traffic["prompt"], _strata(rng, n))
    outputs = _lognormal(traffic["output"], _strata(rng, n))
    due = np.cumsum(-np.log1p(-_strata(rng, n)))
    due *= seconds * (1.0 - 0.5 / n) / due[-1]
    ids = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int64)
    out, at = [], 0
    for i in range(n):
        L = int(prompts[i])
        out.append(Req(i, ids[at:at + L].astype(np.int32), int(outputs[i]), float(due[i])))
        at += L
    return out


def prefill_buckets(traffic: Dict[str, Any]) -> List[int]:
    """Prompt lengths that together reach every prefill shape the cell can
    take on a masking engine (the power-of-two buckets between the shortest
    and the longest prompt), and both ends."""
    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    lens = {lo, hi}
    b = 1 << max(0, (lo - 1).bit_length())
    while b <= hi:
        lens.add(b)
        b *= 2
    return sorted(lens)
