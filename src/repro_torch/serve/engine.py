"""Serving: continuous batching over one stacked KV cache, and the wave
baseline (the port of ``repro/serve/engine.py``, local modes).

Two execution modes, one token stream (greedy decodes are identical across
them):

* **Continuous (default).**  Requests stream through an admission queue into
  a fixed pool of *slots*; each slot owns one row of a stacked KV/SSM
  cache.  Each step's admissions prefill together in constant-``B``
  batches — on attention families bucketed to a power of two with a
  per-sequence pad mask (``Model.prefill(pad_width=...)``, bit-exact), on
  the ssm and hybrid families, whose state scans cannot mask pads, in
  exact-length groups; unused rows are dummies.  Each row is copied into
  its free slot, and every engine step runs ONE batched decode over all
  occupied slots with a per-slot position vector.  Sequences join and leave
  at step boundaries.
* **Wave (baseline).**  Form a wave of ≤B requests, left-pad to a common
  length, prefill once, decode until every member finishes.  Ragged waves
  of attention families carry the per-sequence pad mask so pad slots are
  invisible; the ssm and hybrid families prefill the pads unmasked, as the
  reference does.

The slot cache is made in the shape of the first B-row prefill's cache, and
rows move along each leaf's batch axis as the model states it
(``Model.cache_batch_axes``): axis 1 for the [L, B, S, K, Dh] self-KV, the
enc-dec cross-KV and the mamba2 states, axis 2 for the hybrid's [G, k, B,
...] conv and SSM states.
The reference's pool mode (the loop lowered onto the TaskGraph over device-
resident caches) is not ported yet (ROADMAP item 14b): it builds on the
peer fabric's ``alloc_resident`` / ``propagate_resident`` and needs
``SloPlacement`` (item 10).

On the card every decode step runs as a captured CUDA graph, the port's
counterpart of the reference's ``jax.jit(model.decode_step)``: one graph per
decode signature (mode, batch rows, pad-masked or not), captured right after
that signature's first step, which runs eagerly as the warm-up and counts;
every later step copies its token, positions and pad widths into the graph's
static buffers and replays it (``serve/graph.py``).  The graph covers
``Model.decode_step`` up to the logits; sampling stays outside it, as in the
reference.  The continuous mode's slot cache is static already; wave mode
keeps one static cache per wave size, into which each wave's prefill cache
is copied.  Prefill runs eagerly.  A CPU engine decodes eagerly, and so does
a card engine made with ``eager=True``; a capture that fails raises, and
nothing falls back to the eager route by itself.

With ``use_kernels`` on the card, an unpadded prefill (wave mode with equal
prompt lengths) runs the flash-attention kernel on every layer and every
decode in which no live slot carries pads runs the flash-decode kernel.
Continuous-mode prefill of an attention family is always pad-masked, so it
runs the plain blockwise path, as the reference's does; the ssm and hybrid
families prefill unpadded in both modes, so with ``use_kernels`` every
prefill runs the SSD-scan kernel in each Mamba2 layer and (hybrid) flash
attention in each shared block, and every decode flash decode.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.layers import dtype_of
from ..models.model import Model
from .graph import CapturedStep


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 32
    # per-request deadline, measured from serve() entry (or first submit);
    # a request whose deadline has passed when a slot frees for it is shed
    # (its Result comes back timed_out with no tokens)
    deadline_ms: Optional[float] = None


@dataclass
class Result:
    rid: int
    tokens: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    timed_out: bool = False


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 4                 # slot count (continuous) / wave size
    max_len: int = 256             # cache capacity
    eos: int = -1                  # -1: run to the token budget
    temperature: float = 0.0       # 0 = greedy
    seed: int = 0
    mode: str = "continuous"       # "continuous" | "wave" (baseline)
    # continuous mode: bucket prefill lengths to the next power of two with
    # a pad mask (bit-exact)
    bucket_prefill: bool = True


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _param_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _param_leaves(v)]
    return [tree]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_logits(model: Model, params: Any, token: torch.Tensor, cache: Any,
                   pos: torch.Tensor, pad_width: Optional[torch.Tensor],
                   pad_offset: int) -> torch.Tensor:
    """One decode step's logits; the cache is written in place.  A module
    function over explicit arguments: a captured step holds it, and it must
    not hold the engine (which holds the step)."""
    return model.decode_step(params, token, cache, pos, pad_width=pad_width,
                             pad_offset=pad_offset)[0]


class ServeEngine:
    def __init__(self, model: Model, params: Any, cfg: ServeConfig, *,
                 frontend_seq: int = 0, runtime: Any = None,
                 device: DeviceLike = "cuda", eager: bool = False) -> None:
        """``params`` must sit on ``device`` (the card unless the caller asks
        for the CPU; raises without one).  ``frontend_seq`` > 0 supplies
        zero-stub frontend embeddings (vlm patch embeds / enc-dec encoder
        frames).  On the card the decode steps replay captured CUDA graphs
        unless ``eager`` asks for the eager route."""
        if cfg.mode not in ("continuous", "wave"):
            raise ValueError(f"unknown serve mode {cfg.mode!r}")
        if runtime is not None:
            raise NotImplementedError(
                "pool-mode serving is not ported yet (ROADMAP.md item 14b): it "
                "needs SloPlacement (item 10)")
        self.device = resolve_device(device)
        where = {str(leaf.device) for leaf in _param_leaves(params)}
        if where != {str(self.device)}:
            raise ValueError(f"params live on {sorted(where)}, not {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.frontend_seq = frontend_seq
        mcfg = model.cfg
        self._front_key = "enc_embeds" if mcfg.is_encdec else "embeds"
        self._prefix = frontend_seq if not mcfg.is_encdec else 0
        self._can_mask = mcfg.family not in ("ssm", "hybrid")
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # captured decode graphs by signature, and wave mode's static
        # decode inputs by wave size
        self._captured = self.device.type == "cuda" and not eager
        self._graphs: Dict[Tuple, CapturedStep] = {}
        self._decodes = 0
        self._w_static: Dict[int, Dict[str, Any]] = {}
        # admission queue + counters
        self._pending: deque = deque()
        self._t0: Optional[float] = None
        self._steps = 0
        self._shed = 0
        # continuous-mode slot state, built at the first admission
        self._slots_ready = False

    # -- shared helpers -------------------------------------------------------
    def _stub(self, B: int) -> torch.Tensor:
        return torch.zeros(B, self.frontend_seq, self.model.cfg.d_model,
                           dtype=dtype_of(self.model.cfg.compute_dtype),
                           device=self.device)

    def _batch(self, toks: np.ndarray) -> Dict[str, torch.Tensor]:
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.frontend_seq:
            batch[self._front_key] = self._stub(toks.shape[0])
        return batch

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [B, 1, V] → token [B, 1] int32 (greedy: the first maximum)."""
        last = logits[:, -1].to(torch.float32)
        if self.cfg.temperature <= 0.0:
            return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(last / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen).to(torch.int32)

    def _decode(self, key: Tuple, fn) -> torch.Tensor:
        """The logits of the decode step ``fn`` (no arguments: it reads the
        static inputs): eagerly, or by the captured graph of its signature
        ``key``, captured at the signature's first step (``fn`` is used only
        then)."""
        self._decodes += 1
        if not self._captured:
            return fn()
        step = self._graphs.get(key)
        if step is None:
            step = self._graphs[key] = CapturedStep(fn, self.device)
        return step()

    @property
    def graph_stats(self) -> Dict[str, int]:
        """Decode steps run so far, graphs captured (each at its signature's
        first step) and steps that replayed one."""
        return {"decodes": self._decodes, "graphs": len(self._graphs),
                "replays": sum(g.replays for g in self._graphs.values())}

    def _check_fits(self, r: Request) -> None:
        need = self._prefix + len(r.prompt) + r.max_new_tokens
        if need > self.cfg.max_len:
            raise ValueError(f"request {r.rid} exceeds cache capacity "
                             f"({need} > {self.cfg.max_len})")

    # -- streaming API --------------------------------------------------------
    def submit(self, *requests: Request) -> None:
        """Enqueue requests; they are admitted as slots free up."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        for r in requests:
            self._check_fits(r)
            self._pending.append(r)

    @property
    def has_work(self) -> bool:
        if self._pending:
            return True
        return self._slots_ready and bool(self._c_active.any())

    def step(self) -> List[Result]:
        """One engine step: admit into free slots (shedding expired
        deadlines), append each live sequence's pending token (retiring
        finished ones), then run one batched decode.  Returns the Results
        completed this step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return self._step_local()

    def drain(self) -> Dict[int, Result]:
        out: Dict[int, Result] = {}
        while self.has_work:
            for res in self.step():
                out[res.rid] = res
        return out

    # -- request loop ---------------------------------------------------------
    def serve(self, requests: Sequence[Request]) -> Dict[int, Result]:
        """Serve a request list; returns {rid: Result} + prints stats.

        Requests carrying ``deadline_ms`` are load-shed: if a request's
        deadline (from this call's start) has expired by the time a slot
        frees for it, it is answered with a ``timed_out`` :class:`Result`.
        """
        if self.cfg.mode == "wave":
            return self._serve_waves(requests)
        self._t0 = time.perf_counter()
        self._steps = 0
        self._shed = 0
        out: Dict[int, Result] = {}
        self.submit(*requests)
        while self.has_work:
            for res in self.step():
                out[res.rid] = res
        wall = time.perf_counter() - self._t0
        new_tokens = sum(len(r.tokens) for r in out.values())
        if wall > 0:
            extra = f", {self._shed} shed" if self._shed else ""
            print(f"[serve] {len(requests)} requests, {self._steps} steps"
                  f"{extra}, {new_tokens} new tokens, "
                  f"{new_tokens / wall:.1f} tok/s", flush=True)
        self._t0 = None
        return out

    # ========================================================================
    # continuous mode: slot-batched decode
    # ========================================================================
    def _ensure_slots(self) -> None:
        if self._slots_ready:
            return
        B = self.cfg.batch
        self._c_cache = None                  # shaped at the first prefill
        self._c_axes = _leaves(self.model.cache_batch_axes())
        self._c_pos = np.zeros(B, np.int32)
        self._c_pw = np.zeros(B, np.int32)
        # the decode's static inputs: pending tokens, fills, pad widths
        self._c_tok = torch.zeros(B, 1, dtype=torch.int32, device=self.device)
        self._c_posd = torch.zeros(B, dtype=torch.int32, device=self.device)
        self._c_pwd = torch.zeros(B, dtype=torch.int32, device=self.device)
        self._c_active = np.zeros(B, bool)
        self._c_req: List[Optional[Request]] = [None] * B
        self._c_res: List[Optional[Result]] = [None] * B
        self._slots_ready = True

    def _prefill_groups(self, admits: List[Tuple[Request, int]]
                        ) -> List[Tuple[List[Tuple[Request, int]], int]]:
        """Partition this step's admissions into batchable prefill groups.

        Attention families pad-mask, so any mix of lengths shares one
        prefill at the group's (bucketed) max length — except members whose
        token budget can't afford the padding, which start their own group.
        SSM/hybrid families can't mask, so only equal-length prompts batch.
        Returns [(members, padded_len)], on attention families with members
        sorted longest-first.
        """
        if not self._can_mask:
            by_len: Dict[int, List[Tuple[Request, int]]] = {}
            for r, b in admits:
                by_len.setdefault(len(r.prompt), []).append((r, b))
            return [(members, L) for L, members in sorted(by_len.items())]
        groups: List[Tuple[List[Tuple[Request, int]], int]] = []
        for r, b in sorted(admits, key=lambda rb: -len(rb[0].prompt)):
            L = len(r.prompt)
            for g in groups:
                if self._prefix + g[1] + r.max_new_tokens <= self.cfg.max_len:
                    g[0].append((r, b))
                    break
            else:
                Lb = L
                if self.cfg.bucket_prefill:
                    Lb = max(4, 1 << (L - 1).bit_length())
                    if self._prefix + Lb + r.max_new_tokens > self.cfg.max_len:
                        Lb = L
                groups.append(([(r, b)], Lb))
        return groups

    def _admit_local(self, admits: List[Tuple[Request, int]]) -> None:
        t0 = time.perf_counter()
        B = self.cfg.batch
        for members, S in self._prefill_groups(admits):
            # pad the group to a constant B rows; dummy rows keep one valid
            # token (rows are independent and never inserted)
            toks = np.zeros((B, S), np.int32)
            pw = np.full(B, S - 1, np.int32)
            for i, (r, _) in enumerate(members):
                L = len(r.prompt)
                toks[i, S - L:] = np.asarray(r.prompt, np.int32)
                pw[i] = S - L
            pad = torch.from_numpy(pw).to(self.device) if self._can_mask else None
            logits, cache_k, pos1 = self.model.prefill(
                self.params, self._batch(toks), cache_len=self.cfg.max_len,
                pad_width=pad)
            tok_k = self._sample(logits)
            if self._c_cache is None:
                self._c_cache = _tree_map(torch.zeros_like, cache_k)
            slots, news = _leaves(self._c_cache), _leaves(cache_k)
            for i, (r, b) in enumerate(members):
                for slot, new, ax in zip(slots, news, self._c_axes):
                    slot.select(ax, b).copy_(new.select(ax, i))
                self._c_pos[b] = int(pos1)
                self._c_pw[b] = pw[i]
                self._c_tok[b] = tok_k[i]
                self._c_req[b] = r
                self._c_res[b] = Result(r.rid)
                self._c_active[b] = True
        _sync(self.device)
        dt = (time.perf_counter() - t0) / len(admits)
        for r, b in admits:
            self._c_res[b].prefill_s = dt

    def _shed_or_none(self, elapsed_ms: float) -> Optional[Request]:
        """Pop the next admissible request, shedding expired deadlines."""
        while self._pending:
            r = self._pending.popleft()
            if r.deadline_ms is not None and elapsed_ms >= r.deadline_ms:
                self._shed_out.append(Result(r.rid, timed_out=True))
                self._shed += 1
                continue
            return r
        return None

    def _step_local(self) -> List[Result]:
        self._ensure_slots()
        completed: List[Result] = []
        self._shed_out = completed
        elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        # 1. admission into free slots (batched prefill per step)
        free = [b for b in range(self.cfg.batch) if not self._c_active[b]]
        admits: List[Tuple[Request, int]] = []
        while free and self._pending:
            r = self._shed_or_none(elapsed_ms)
            if r is None:
                break
            admits.append((r, free.pop(0)))
        if admits:
            self._admit_local(admits)
        # 2. consume pending tokens; retire finished sequences
        if self._c_active.any():
            tok_host = self._c_tok.cpu().numpy()
            for b in range(self.cfg.batch):
                if not self._c_active[b]:
                    continue
                t = int(tok_host[b, 0])
                r, res = self._c_req[b], self._c_res[b]
                res.tokens.append(t)
                if t == self.cfg.eos or len(res.tokens) >= r.max_new_tokens:
                    completed.append(res)
                    self._c_active[b] = False
                    self._c_pw[b] = 0
                    self._c_req[b] = self._c_res[b] = None
        # 3. one batched decode over the remaining live slots
        act = self._c_active.copy()
        if act.any():
            t0 = time.perf_counter()
            self._c_posd.copy_(torch.from_numpy(self._c_pos))
            # no live slot carries pads (or the family cannot mask): take
            # the unmasked decode (bit-identical where the mask is the
            # identity)
            masked = self._can_mask and bool(self._c_pw.any())
            if masked:
                self._c_pwd.copy_(torch.from_numpy(self._c_pw))
            logits = self._decode(("continuous", self.cfg.batch, masked), functools.partial(
                _decode_logits, self.model, self.params, self._c_tok, self._c_cache,
                self._c_posd, self._c_pwd if masked else None, self._prefix))
            nxt = self._sample(logits)
            live = torch.from_numpy(act).to(self.device)[:, None]
            self._c_tok.copy_(torch.where(live, nxt, self._c_tok))
            _sync(self.device)
            self._c_pos[act] += 1
            dt = (time.perf_counter() - t0) / int(act.sum())
            for b in np.flatnonzero(act):
                self._c_res[b].decode_s += dt
        if act.any() or completed:
            self._steps += 1
        return completed

    # ========================================================================
    # wave mode (baseline)
    # ========================================================================
    def run_wave(self, reqs: Sequence[Request]) -> List[Result]:
        if len(reqs) > self.cfg.batch:
            raise ValueError(f"wave of {len(reqs)} exceeds batch {self.cfg.batch}")
        results = [Result(r.rid) for r in reqs]
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = np.asarray(r.prompt, np.int32)
        pw = np.asarray([S - len(r.prompt) for r in reqs], np.int32)
        budget = max(r.max_new_tokens for r in reqs)
        if S + self._prefix + budget > self.cfg.max_len:
            raise ValueError("wave exceeds cache capacity")
        # ragged waves of attention families carry a per-sequence pad mask:
        # pad slots drop out of every attention and rope positions shift, so
        # a padded row decodes as its unpadded reference; the ssm and hybrid
        # families scan the pads unmasked, as the reference's do
        masked = self._can_mask and bool(pw.any())
        pad = torch.from_numpy(pw).to(self.device) if masked else None

        t0 = time.perf_counter()
        logits, cache, pos = self.model.prefill(
            self.params, self._batch(toks), cache_len=self.cfg.max_len,
            pad_width=pad)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        tok = self._sample(logits)
        st = self._wave_inputs(len(reqs), cache, pad)
        del cache
        key = ("wave", len(reqs), masked)
        step = functools.partial(_decode_logits, self.model, self.params, st["tok"],
                                 st["cache"], st["pos"], st["pw"] if masked else None,
                                 self._prefix)
        done = np.zeros(len(reqs), bool)
        for _ in range(budget):
            tok_host = tok.cpu().numpy()
            for i, r in enumerate(reqs):
                if not done[i]:
                    t = int(tok_host[i, 0])
                    results[i].tokens.append(t)
                    if t == self.cfg.eos or len(results[i].tokens) >= r.max_new_tokens:
                        done[i] = True
            if done.all():
                break
            st["tok"].copy_(tok)
            st["pos"].fill_(pos)
            logits = self._decode(key, step)
            pos = pos + 1
            tok = self._sample(logits)
        t_decode = time.perf_counter() - t0
        for r in results:
            r.prefill_s = t_prefill / len(reqs)
            r.decode_s = t_decode / len(reqs)
        return results

    def _wave_inputs(self, rows: int, cache: Any,
                     pad: Optional[torch.Tensor]) -> Dict[str, Any]:
        """The decode's static inputs for a wave of ``rows``: pending tokens,
        the fill (one for every row), pad widths and the cache.  The
        captured route keeps one set per wave size, whose graphs read it,
        and copies this wave's prefill cache and pad widths into it, so
        nothing of an earlier wave stays; the eager route takes the wave's
        own cache."""
        st = self._w_static.get(rows) if self._captured else None
        if st is None:
            zeros = functools.partial(torch.zeros, dtype=torch.int32, device=self.device)
            st = {"cache": cache, "tok": zeros(rows, 1), "pos": zeros(rows),
                  "pw": zeros(rows)}
            if self._captured:
                self._w_static[rows] = st
        else:
            for static, new in zip(_leaves(st["cache"]), _leaves(cache)):
                static.copy_(new)
        if pad is not None:
            st["pw"].copy_(pad)
        return st

    def _serve_waves(self, requests: Sequence[Request]) -> Dict[int, Result]:
        out: Dict[int, Result] = {}
        B = self.cfg.batch
        new_tokens = 0
        shed = 0
        t0 = time.perf_counter()
        pending = list(requests)
        waves = 0
        while pending:
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            live: List[Request] = []
            while pending and len(live) < B:
                r = pending.pop(0)
                if r.deadline_ms is not None and elapsed_ms >= r.deadline_ms:
                    out[r.rid] = Result(r.rid, timed_out=True)
                    shed += 1
                    continue
                live.append(r)
            if not live:
                continue
            waves += 1
            for res in self.run_wave(live):
                out[res.rid] = res
                new_tokens += len(res.tokens)
        wall = time.perf_counter() - t0
        if wall > 0:
            extra = f", {shed} shed" if shed else ""
            print(f"[serve] {len(requests)} requests, {waves} waves{extra}, "
                  f"{new_tokens} new tokens, {new_tokens / wall:.1f} tok/s",
                  flush=True)
        return out
