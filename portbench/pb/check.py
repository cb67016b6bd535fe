"""Whether the timed path served the right tokens.

Once the window has closed and the engine is gone, a sample of the
finished requests, drawn from the seed (the longest request always in it,
then others in a seeded order until ``sample_tokens`` served tokens), goes
through the plain reference once (the configuration's own
``references/<config>.py``, or :func:`reference.logits`; see
:func:`pb.spec.reference_logits`): prompt and served tokens, teacher-forced.
At each served position the number compared is the gap by which the served
token's logit lies below the reference's best logit there; the run's number
is the widest gap.  A greedy engine that computes the model right serves
the reference's best token or one within its rounding of it.

The control runs the same reference at the next precision below the
configuration's (float8 e4m3 matrix products, :class:`reference.FP8`) in
the program's place: at each position it puts first the token it computes
best, and its number is that token's gap in the float32 reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from . import reference
from .timeline import Served


def sample(served: Sequence[Served], seed: int, tokens: int) -> List[Served]:
    done = [s for s in served if s.finished]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    longest = max(done, key=lambda s: (s.prompt_len + len(s.tokens), -s.index))
    picked, count = [longest], len(longest.tokens)
    for j in rng.permutation(len(done)):
        if count >= tokens:
            break
        s = done[int(j)]
        if s is not longest:
            picked.append(s)
            count += len(s.tokens)
    return picked


def _sequence(prompt: np.ndarray, served: List[int], device):
    seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(served[:-1], np.int64)])
    L = len(prompt)
    rows = torch.arange(L - 1, L - 1 + len(served), device=device)
    return torch.from_numpy(seq).to(device), rows


Logits = Callable[..., torch.Tensor]


def gaps(params: Any, conf: Dict[str, Any], prompt: np.ndarray, served: List[int],
         logits: Logits, control: bool = False) -> Dict[str, float]:
    """The widest gap of ``served`` in the float32 reference ``logits``;
    with ``control``, also that of the float8 reference's own best tokens."""
    device = params["final_norm"].device
    seq, rows = _sequence(prompt, served, device)
    with reference.exact_float32(), torch.no_grad():
        ref = logits(params, conf, seq, rows, reference.FP32)
        best = ref.max(-1).values
        tok = torch.as_tensor(served, device=device).long()
        out = {"gap": float((best - ref.gather(1, tok[:, None])[:, 0]).max())}
        if control:
            low = logits(params, conf, seq, rows, reference.FP8())
            pick = low.argmax(-1)
            out["control_gap"] = float((best - ref.gather(1, pick[:, None])[:, 0]).max())
    return out


def widest(params: Any, conf: Dict[str, Any], picked: Sequence[Served],
           prompts: Sequence[np.ndarray], logits: Logits,
           control: bool = False) -> Dict[str, float]:
    out = {"gap": 0.0, "tokens": 0, "requests": len(picked)}
    if control:
        out["control_gap"] = 0.0
    for s in picked:
        g = gaps(params, conf, prompts[s.index], s.tokens, logits, control)
        out["tokens"] += len(s.tokens)
        for k in ("gap", "control_gap"):
            if k in g:
                out[k] = max(out[k], g[k])
    return out
