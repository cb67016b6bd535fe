"""Serving: continuous batching over one stacked KV cache, the wave
baseline, and pool mode over the offload runtime (the port of
``repro/serve/engine.py``).

Three execution modes, one token stream (greedy decodes are identical across
them):

* **Continuous (default).**  Requests stream through an admission queue into
  a fixed pool of *slots*; each slot owns one row of a stacked KV/SSM
  cache.  How a step's admissions prefill depends on the model's route.
  On the plain route (``use_kernels=False``) they prefill together in
  constant-``B`` batches, unused rows dummies — on attention families
  bucketed to a power of two with a per-sequence pad mask
  (``Model.prefill(pad_width=...)``, bit-exact), on the ssm and hybrid
  families, whose state scans cannot mask pads, in exact-length groups.
  On the kernel route (``use_kernels``) they prefill unpadded: one group
  per prompt length, holding only its real rows, so no slot carries pads.
  An MoE layer's expert capacity counts the tokens of its prefill, so
  there only real tokens compete for it, where the plain route's dummy and
  pad tokens (and the reference's) compete too: past capacity the two
  routes may drop different assignments.  Each row is copied into its free slot, and every engine step runs ONE
  batched decode over all occupied slots with a per-slot position vector.
  Sequences join and leave at step boundaries.
* **Wave (baseline).**  Form a wave of ≤B requests, left-pad to a common
  length, prefill once, decode until every member finishes.  Ragged waves
  of attention families carry the per-sequence pad mask so pad slots are
  invisible; the ssm and hybrid families prefill the pads unmasked, as the
  reference does.
* **Pool.**  With a :class:`~repro_torch.core.ClusterRuntime`, the
  continuous loop lowers onto the TaskGraph: each admission and each
  per-sequence decode step is a ``TaskNode`` (registered kernels
  ``serve_prefill`` / ``serve_decode``) whose one-sequence cache lives in a
  device data environment — ``device_out`` keeps it resident, ``present``
  binds it without host traffic, and a capacity-bounded present table spills
  cold sequences to the host and refetches them at their next step.  The
  weights are resident and pinned on every device that serves.  Admissions
  are placed by a policy (default ``"slo"``); with ``migrate_every`` a hot
  sequence's cache moves off the deepest device queue over the runtime's
  transport (``propagate_resident``).  Deadline shedding and hedging
  (``stragglers=``) ride through ``run_graph``.

The slot cache is made in the dtypes and shapes of the first prefill's
cache, with B rows, and rows move along each leaf's batch axis as the model
states it
(``Model.cache_batch_axes``): axis 1 for the [L, B, S, K, Dh] self-KV, the
enc-dec cross-KV and the mamba2 states, axis 2 for the hybrid's [G, k, B,
...] conv and SSM states.
Pool mode's entry bodies run eagerly on a virtual device's worker thread,
under its stream, at one sequence each: an unpadded prefill (with
``use_kernels`` on the card, the flash-attention kernel on every layer) and
decodes at B = 1 (flash decode); greedy tokens are ``torch.argmax``'s first
maximum, as in the local modes.

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

With ``use_kernels`` on the card, an unpadded prefill (every continuous-mode
admission, and wave mode with equal prompt lengths) runs the flash-attention
kernel on every layer, and every decode in which no live slot carries pads
(every continuous-mode decode) runs the flash-decode kernel.  A pad-masked
prefill (a ragged wave, or continuous mode on the plain route) runs the
plain blockwise path, as the reference's does; the ssm and hybrid families
prefill unpadded in both modes, so with ``use_kernels`` every prefill runs
the SSD-scan kernel in each Mamba2 layer and (hybrid) flash attention in
each shared block, and every decode flash decode.

Each continuous-mode step (not pool or wave mode) leaves a step record and
a record per admitted request in ``serve/telemetry.py``'s process-wide
log, and while a ``torch.profiler`` session records it opens spans where
the work happens: ``serve.step`` around the step; ``serve.prefill``,
``serve.insert`` and ``serve.wait`` in admission; ``serve.retire`` around
the token read-back; ``serve.decode`` (with ``.replay``, ``.capture`` or
``.eager`` inside), ``serve.sample`` and ``serve.wait`` in the decode; the
model's own, in an eager pass, ``model.mla``, ``model.moe.route`` and
``model.moe.experts``.  For a model with MoE layers the step record also
holds what they did in the step's prefills and in its decode apart
(``moe.MoECounts``): each MoE layer writes its tokens per expert into a
device buffer of the engine's (inside the captured graph for the decode),
which is copied to the host behind the step's work and read after the
synchronization the step already makes.  A dropless MoE routes only the
decode's live rows: a free slot's row pulls in no expert.
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
from ..models.moe import MoECounts, expert_counters
from ..models.transformer import moe_layer_count
from . import telemetry
from .graph import CapturedStep
from .telemetry import TELEMETRY, RequestRecord, StepRecord, span


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
    # continuous mode on the plain route: bucket prefill lengths to the
    # next power of two with a pad mask (bit-exact); the kernel route
    # prefills each length unpadded and refuses False
    bucket_prefill: bool = True
    # pool mode: every N steps, if the deepest device queue exceeds the
    # shallowest by >= 2 sequences, migrate the hottest sequence's cache
    # off the tail device (0 = never migrate)
    migrate_every: int = 0


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


# the kernel libraries a family's serve path launches under use_kernels
_SERVE_KERNELS = {"dense": ("flash_attention", "flash_decode"),
                  "moe": ("flash_attention", "flash_decode", "grouped_matmul"),
                  "ssm": ("ssd_scan",),
                  "hybrid": ("ssd_scan", "flash_attention", "flash_decode")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_logits(model: Model, params: Any, token: torch.Tensor, cache: Any,
                   pos: torch.Tensor, pad_width: Optional[torch.Tensor],
                   pad_offset: int, moe_counts: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step's logits; the cache is written in place.  A module
    function over explicit arguments: a captured step holds it, and it must
    not hold the engine (which holds the step)."""
    kw = {} if moe_counts is None else {"moe_counts": moe_counts}
    if live is not None:
        kw["live"] = live
    return model.decode_step(params, token, cache, pos, pad_width=pad_width,
                             pad_offset=pad_offset, **kw)[0]


class _ExpertCounts:
    """The engine's buffers for its MoE layers' tokens per expert: on the
    device [slots, MoE layers, E] for the prefill groups of a step (one
    block a group) and [MoE layers, E] for the decode, and their host
    copies (pinned on the card, so the copies run behind the step's
    work).  A dropless MoE also gets ``live`` [slots] bool on the device,
    the decode's live slots: a free slot's row is routed to no expert, so
    the decode computes, and its counters count, the live rows only."""

    def __init__(self, model: Model, slots: int, device: torch.device) -> None:
        cfg = model.cfg
        shape = (moe_layer_count(cfg), cfg.moe.n_experts)
        self.cfg, self.device = cfg, device
        self.prefill = torch.zeros(slots, *shape, dtype=torch.int32, device=device)
        self.decode = torch.zeros(shape, dtype=torch.int32, device=device)
        self.live = (torch.zeros(slots, dtype=torch.bool, device=device)
                     if cfg.moe.dropless else None)
        pin = device.type == "cuda"
        self._host = {"prefill": torch.zeros(self.prefill.shape, dtype=torch.int32,
                                             pin_memory=pin),
                      "decode": torch.zeros(shape, dtype=torch.int32, pin_memory=pin)}

    def copy_back(self, which: str, n: int = 1) -> None:
        """Queue the copy of the decode's, or the first ``n`` prefill
        groups', counts to the host (read after the step's sync)."""
        src = self.decode if which == "decode" else self.prefill[:n]
        self._host[which][:src.shape[0]].copy_(src, non_blocking=True)

    def read(self, which: str, tokens: Sequence[int]) -> MoECounts:
        """The counters of the decode (``tokens``: its rows) or of the
        prefill groups (``tokens``: each group's rows x length)."""
        host = self._host[which].numpy()
        if which == "decode":
            return expert_counters(host, tokens[0], self.cfg, self.device)
        out = MoECounts()
        for g, T in enumerate(tokens):
            out = out + expert_counters(host[g], T, self.cfg, self.device)
        return out


class ServeEngine:
    def __init__(self, model: Model, params: Any, cfg: ServeConfig, *,
                 frontend_seq: int = 0, runtime: Any = None,
                 policy: Any = None, stragglers: Any = None,
                 device: DeviceLike = "cuda", eager: bool = False) -> None:
        """``params`` must sit on ``device`` (the card unless the caller asks
        for the CPU; raises without one).  ``frontend_seq`` > 0 supplies
        zero-stub frontend embeddings (vlm patch embeds / enc-dec encoder
        frames).  On the card the decode steps replay captured CUDA graphs
        unless ``eager`` asks for the eager route.

        ``runtime`` switches on pool mode; ``policy`` picks its admission
        placement (name or instance, default ``"slo"``); ``stragglers`` is
        forwarded to every ``run_graph``.  In pool mode ``device`` must be
        the runtime's, and ``params`` may sit on the host (the CPU: the
        host's copy, as the reference's host arrays are) or on that device;
        either way each serving device gets its own resident copy
        (``ensure_resident``, counted in ``bytes_to``)."""
        if cfg.mode not in ("continuous", "wave"):
            raise ValueError(f"unknown serve mode {cfg.mode!r}")
        if model.cfg.use_kernels and not cfg.bucket_prefill:
            raise ValueError("bucket_prefill=False has no effect on the kernel route, "
                             "which prefills every length unpadded")
        self.device = resolve_device(device)
        where = {str(leaf.device) for leaf in _param_leaves(params)}
        if runtime is not None:
            if self.device != runtime.device:
                raise ValueError(f"device {self.device} is not the runtime's "
                                 f"{runtime.device}")
            if len(where) != 1 or not where <= {"cpu", str(self.device)}:
                raise ValueError(f"params live on {sorted(where)}, not on the "
                                 f"host or {self.device}")
        elif where != {str(self.device)}:
            raise ValueError(f"params live on {sorted(where)}, not {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.frontend_seq = frontend_seq
        self.runtime = runtime
        self.stragglers = stragglers
        self.migrations = 0
        mcfg = model.cfg
        self._front_key = "enc_embeds" if mcfg.is_encdec else "embeds"
        self._prefix = frontend_seq if not mcfg.is_encdec else 0
        self._can_mask = mcfg.family not in ("ssm", "hybrid")
        # the kernel route admits unpadded: a pad sends a prefill off flash
        # attention and every later decode of its slot off flash decode
        self._pad_mask = self._can_mask and not mcfg.use_kernels
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
        if runtime is not None:
            if cfg.mode == "wave":
                raise ValueError("pool mode serves continuously; "
                                 "use mode='wave' without a runtime")
            self._pool_setup(policy)

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

    def _decode(self, key: Tuple, fn, on: bool = False) -> torch.Tensor:
        """The logits of the decode step ``fn`` (no arguments: it reads the
        static inputs): eagerly, or by the captured graph of its signature
        ``key``, captured at the signature's first step (``fn`` is used only
        then).  ``on``: open the route's span."""
        self._decodes += 1
        if not self._captured:
            with span(on, "serve.decode.eager"):
                return fn()
        step = self._graphs.get(key)
        if step is None:
            step = self._graphs[key] = CapturedStep(fn, self.device)
            with span(on, "serve.decode.capture"):
                return step()
        with span(on, "serve.decode.replay"):
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
        if self.runtime is not None:
            return bool(self._p_active)
        return self._slots_ready and bool(self._c_active.any())

    def step(self) -> List[Result]:
        """One engine step: admit into free slots (shedding expired
        deadlines), append each live sequence's pending token (retiring
        finished ones), then run one batched decode / one decode TaskGraph.
        Returns the Results completed this step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if self.runtime is not None:
            return self._step_pool()
        # spans only while a profiler records; the step's record always
        on = telemetry.recording()
        rec = StepRecord(time.perf_counter(), on)
        with span(on, "serve.step", lambda: f"step={self._steps}"):
            completed = self._step_local(rec, on)
        rec.t1 = time.perf_counter()
        TELEMETRY.step_log.append(rec)
        return completed

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
            if self.migrations:
                extra += f", {self.migrations} migrations"
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
        self._c_rec: List[Optional[RequestRecord]] = [None] * B
        self._c_moe = (_ExpertCounts(self.model, B, self.device)
                       if self.model.cfg.family == "moe" else None)
        self._slots_ready = True

    def _prefill_groups(self, admits: List[Tuple[Request, int]]
                        ) -> List[Tuple[List[Tuple[Request, int]], int]]:
        """Partition this step's admissions into batchable prefill groups.

        On the plain route attention families pad-mask, so any mix of
        lengths shares one prefill at the group's (bucketed) max length —
        except members whose token budget can't afford the padding, which
        start their own group.  SSM/hybrid families can't mask, and the
        kernel route admits unpadded, so there only equal-length prompts
        batch.  Returns [(members, padded_len)], pad-masked groups with
        members sorted longest-first.
        """
        if not self._pad_mask:
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

    def _admit_local(self, admits: List[Tuple[Request, int]], rec: StepRecord,
                     on: bool) -> None:
        t0 = time.perf_counter()
        B = self.cfg.batch
        moe, group_tokens = self._c_moe, []
        for g, (members, S) in enumerate(self._prefill_groups(admits)):
            t_group = time.perf_counter()
            # the plain route pads the group to a constant B rows; the
            # kernel route prefills the members' rows only
            rows = len(members) if self.model.cfg.use_kernels else B
            with span(on, "serve.prefill", lambda: (
                    f"rids={[r.rid for r, _ in members]} rows={rows} padded_len={S}")):
                # dummy rows keep one valid token (rows are independent and
                # never inserted)
                toks = np.zeros((rows, S), np.int32)
                pw = np.full(rows, S - 1, np.int32)
                for i, (r, _) in enumerate(members):
                    L = len(r.prompt)
                    toks[i, S - L:] = np.asarray(r.prompt, np.int32)
                    pw[i] = S - L
                pad = torch.from_numpy(pw).to(self.device) if self._pad_mask else None
                kw = {} if moe is None else {"moe_counts": moe.prefill[g]}
                logits, cache_k, pos1 = self.model.prefill(
                    self.params, self._batch(toks), cache_len=self.cfg.max_len,
                    pad_width=pad, **kw)
                tok_k = self._sample(logits)
            rec.prefill_tokens += rows * S
            group_tokens.append(rows * S)
            rec.prompt_tokens += sum(len(r.prompt) for r, _ in members)
            with span(on, "serve.insert"):
                if self._c_cache is None:
                    self._c_cache = self._slot_cache(cache_k)
                slots, news = _leaves(self._c_cache), _leaves(cache_k)
                for i, (r, b) in enumerate(members):
                    for slot, new, ax in zip(slots, news, self._c_axes):
                        slot.select(ax, b).copy_(new.select(ax, i))
                    self._c_pos[b] = int(pos1)
                    self._c_pw[b] = pw[i]
                    self._c_tok[b] = tok_k[i]
                    self._c_req[b] = r
                    self._c_res[b] = Result(r.rid)
                    self._c_rec[b] = RequestRecord(r.rid, len(r.prompt), S, t_group)
                    TELEMETRY.request_log.append(self._c_rec[b])
                    self._c_active[b] = True
        if moe is not None:
            moe.copy_back("prefill", len(group_tokens))
        with span(on, "serve.wait"):
            _sync(self.device)
        if moe is not None:
            rec.moe_prefill = moe.read("prefill", group_tokens)
        dt = (time.perf_counter() - t0) / len(admits)
        for r, b in admits:
            self._c_res[b].prefill_s = dt

    def _slot_cache(self, cache: Any) -> Any:
        """Zeros in ``cache``'s dtypes and shapes, with ``batch`` rows along
        each leaf's batch axis (a kernel-route prefill has fewer)."""
        axes = iter(self._c_axes)

        def slots(leaf: torch.Tensor) -> torch.Tensor:
            shape = list(leaf.shape)
            shape[next(axes)] = self.cfg.batch
            return leaf.new_zeros(shape)
        return _tree_map(slots, cache)

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

    def _step_local(self, rec: StepRecord, on: bool) -> List[Result]:
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
            self._admit_local(admits, rec, on)
        # 2. consume pending tokens; retire finished sequences
        if self._c_active.any():
            with span(on, "serve.retire"):
                tok_host = self._c_tok.cpu().numpy()
                t_read = time.perf_counter()
                for b in range(self.cfg.batch):
                    if not self._c_active[b]:
                        continue
                    t = int(tok_host[b, 0])
                    r, res = self._c_req[b], self._c_res[b]
                    res.tokens.append(t)
                    if len(res.tokens) == 1:
                        self._c_rec[b].t_first = t_read
                    if t == self.cfg.eos or len(res.tokens) >= r.max_new_tokens:
                        completed.append(res)
                        self._c_active[b] = False
                        # a free slot still decodes: at fill 0 flash decode
                        # reads one row of it, not its last request's
                        self._c_pos[b] = self._c_pw[b] = 0
                        self._c_req[b] = self._c_res[b] = self._c_rec[b] = None
        # 3. one batched decode over the remaining live slots
        act = self._c_active.copy()
        if act.any():
            t0 = time.perf_counter()
            self._c_posd.copy_(torch.from_numpy(self._c_pos))
            moe = self._c_moe
            if moe is not None and moe.live is not None:
                moe.live.copy_(torch.from_numpy(act))
            # no live slot carries pads (or the family cannot mask): take
            # the unmasked decode (bit-identical where the mask is the
            # identity)
            masked = self._can_mask and bool(self._c_pw.any())
            with span(on, "serve.decode", lambda: (
                    f"rids={[self._c_req[b].rid for b in np.flatnonzero(act)]} "
                    f"masked={masked}")):
                if masked:
                    self._c_pwd.copy_(torch.from_numpy(self._c_pw))
                logits = self._decode(("continuous", self.cfg.batch, masked), functools.partial(
                    _decode_logits, self.model, self.params, self._c_tok, self._c_cache,
                    self._c_posd, self._c_pwd if masked else None, self._prefix,
                    *(() if moe is None else (moe.decode, moe.live))), on)
                rec.t_launch = time.perf_counter()
            rec.decode_rows, rec.masked = int(act.sum()), masked
            with span(on, "serve.sample"):
                nxt = self._sample(logits)
            # the copy from pageable host memory blocks until the stream
            # has run the decode: the host's wait for the card starts here
            with span(on, "serve.wait"):
                live = torch.from_numpy(act).to(self.device)[:, None]
                self._c_tok.copy_(torch.where(live, nxt, self._c_tok))
                if moe is not None:
                    moe.copy_back("decode")
                _sync(self.device)
            rec.t_synced = time.perf_counter()
            if moe is not None:
                # a dropless MoE routes the live rows only; any other, every row
                rec.moe_decode = moe.read("decode", [self.cfg.batch])
            self._c_pos[act] += 1
            dt = (time.perf_counter() - t0) / int(act.sum())
            for b in np.flatnonzero(act):
                self._c_res[b].decode_s += dt
        if act.any() or completed:
            self._steps += 1
        return completed

    # ========================================================================
    # pool mode: the continuous loop lowered onto the TaskGraph
    # ========================================================================
    def _pool_setup(self, policy: Any) -> None:
        from ..core.taskgraph import PlacementContext, resolve_policy
        from ..core.transport import PeerTransport
        if self.cfg.temperature > 0:
            raise ValueError("pool-mode serving is greedy-only")
        rt = self.runtime
        self.ex, self.pool = rt.ex, rt.pool
        self._policy = resolve_policy("slo" if policy is None else policy)
        self._D = len(rt.pool)
        self._ctx = PlacementContext(
            pool=rt.pool, cost=rt.pool.cost, D=self._D,
            peer=isinstance(rt.transport, PeerTransport),
            transport=rt.transport)
        self._policy.begin(self._ctx)
        self._adm_idx = 0
        self._params_on: set = set()
        # rid -> {req, res, device, entry, pos, tok}
        self._p_active: Dict[int, Dict[str, Any]] = {}
        self._ctpl = self._cache_struct()
        self._register_kernels()

    def _cache_struct(self) -> Any:
        """The :class:`TensorSpec` tree of one sequence's decode cache (the
        reference's ``_cache_struct(1)``): a 4-token prefill on meta tensors
        through the plain route (shapes do not depend on the prompt)."""
        from ..core.mediary import TensorSpec
        meta = torch.device("meta")
        cfg = self.model.cfg
        params = _tree_map(lambda t: t.to(meta), self.params)
        batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32, device=meta)}
        if self.frontend_seq:
            batch[self._front_key] = torch.zeros(
                1, self.frontend_seq, cfg.d_model,
                dtype=dtype_of(cfg.compute_dtype), device=meta)
        _, cache, _ = Model(cfg.replace(use_kernels=False)).prefill(
            params, batch, cache_len=self.cfg.max_len)
        return _tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), cache)

    def _register_kernels(self) -> None:
        """Register ``serve_prefill`` / ``serve_decode`` under the
        reference's names.  The entries live as long as the table (by
        default the process-global one), so they hold a parameter-free
        ``Model`` of this config, never the caller's (whose ``params`` may
        be a model's weights), and an entry registered for another config
        under the same name is refused, not reused."""
        mcfg = self.model.cfg
        key = f"{mcfg.name}:{self.cfg.max_len}:{self.frontend_seq}"
        self._kp, self._kd = f"serve_prefill:{key}", f"serve_decode:{key}"
        model, max_len = Model(mcfg), self.cfg.max_len
        front_key = self._front_key
        table = self.pool.table
        for name in (self._kp, self._kd):
            if name in table:
                theirs = getattr(table.lookup(table.index_of(name)).fn, "cfg", None)
                if theirs != mcfg:
                    raise ValueError(f"kernel {name!r} is registered for another "
                                     "model config; give the runtime its own "
                                     "KernelTable")
        if self._kp not in table:
            def serve_prefill(params, toks, embeds=None):
                batch = {"tokens": toks}
                if embeds is not None:
                    batch[front_key] = embeds
                logits, cache, _ = model.prefill(params, batch,
                                                 cache_len=max_len)
                tok = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
                return {"out": tok.to(torch.int32)[:, None], "cache": cache}
            serve_prefill.cfg = mcfg
            table.register(self._kp, serve_prefill)
        if self._kd not in table:
            def serve_decode(params, cache, tok, pos):
                # tok and pos are firstprivate host tensors: copied onto
                # the device on this device's stream
                dev = _leaves(cache)[0].device
                logits, new_cache = model.decode_step(params, tok.to(dev), cache,
                                                      pos.to(dev))
                nxt = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
                return {"out": nxt.to(torch.int32)[:, None], "cache": new_cache}
            serve_decode.cfg = mcfg
            table.register(self._kd, serve_decode)
        if self.device.type == "cuda" and mcfg.use_kernels:
            # load the serving kernels here, not first on two device
            # workers at once
            from ..kernels import _build
            for name in _SERVE_KERNELS.get(mcfg.family, _SERVE_KERNELS["dense"]):
                _build.library(name)

    def _ensure_params(self, d: int) -> None:
        if d in self._params_on:
            return
        self.ex.ensure_resident(d, "serve:params", _serve_params=self.params)
        # the weights are every step's hot set: exempt them from capacity
        # eviction so pressure lands on cold sequence caches instead
        self.ex.pin_resident(d, "_serve_params")
        self._params_on.add(d)

    def _place_admission(self, r: Request) -> int:
        from ..core.taskgraph import TaskNode
        self._ctx.healthy = self.pool.health.healthy(self._D)
        node = TaskNode(name=f"adm{r.rid}", kernel=self._kd)
        d = self._policy.place(self._ctx, node, self._adm_idx,
                               f"serve:adm{r.rid}")
        self._adm_idx += 1
        return d

    def _pool_admit(self, reqs: List[Request]) -> None:
        from ..core.mediary import TensorSpec
        from ..core.target import MapSpec
        from ..core.taskgraph import TaskGraph, TaskNode, run_graph
        t0 = time.perf_counter()
        g = TaskGraph()
        metas = []
        for r in reqs:
            d = self._place_admission(r)
            self._ensure_params(d)
            entry = f"_serve_c{r.rid}"
            self.ex.alloc_resident(d, entry, self._ctpl, tag=f"serve:c{r.rid}")
            to: Dict[str, Any] = {"toks": torch.tensor([list(r.prompt)],
                                                       dtype=torch.int32)}
            if self.frontend_seq:
                to["embeds"] = torch.zeros(
                    1, self.frontend_seq, self.model.cfg.d_model,
                    dtype=dtype_of(self.model.cfg.compute_dtype))

            def mm(deps, to=to, entry=entry):
                return MapSpec(
                    to=to, present={"params": "_serve_params"},
                    device_out={"cache": entry},
                    from_={"out": TensorSpec((1, 1), torch.int32)})

            g.add(TaskNode(name=f"p{r.rid}", kernel=self._kp, make_maps=mm,
                           device=d, tag=f"serve:p{r.rid}"))
            metas.append((r, d, entry))
        res = run_graph(self.ex, g, policy=self._policy, tag="serve",
                        stragglers=self.stragglers)
        dt = (time.perf_counter() - t0) / len(reqs)
        for r, d, entry in metas:
            self._p_active[r.rid] = {
                "req": r, "res": Result(r.rid, prefill_s=dt), "device": d,
                "entry": entry, "pos": self._prefix + len(r.prompt),
                "tok": int(res[f"p{r.rid}"][0, 0])}

    def _pool_decode(self) -> None:
        from ..core.mediary import TensorSpec
        from ..core.target import MapSpec
        from ..core.taskgraph import TaskGraph, TaskNode, run_graph
        t0 = time.perf_counter()
        g = TaskGraph()
        for rid, st in self._p_active.items():
            tok = torch.full((1, 1), st["tok"], dtype=torch.int32)
            pos = torch.tensor(st["pos"], dtype=torch.int32)

            def mm(deps, tok=tok, pos=pos, entry=st["entry"]):
                return MapSpec(
                    firstprivate={"tok": tok, "pos": pos},
                    present={"params": "_serve_params", "cache": entry},
                    device_out={"cache": entry},
                    from_={"out": TensorSpec((1, 1), torch.int32)})

            g.add(TaskNode(name=f"d{rid}", kernel=self._kd, make_maps=mm,
                           device=st["device"], tag=f"serve:d{rid}"))
        res = run_graph(self.ex, g, policy=self._policy, tag="serve",
                        stragglers=self.stragglers)
        dt = (time.perf_counter() - t0) / len(self._p_active)
        for rid, st in self._p_active.items():
            st["tok"] = int(res[f"d{rid}"][0, 0])
            st["pos"] += 1
            st["res"].decode_s += dt

    def _maybe_migrate(self) -> None:
        """Move the hottest sequence off the deepest device queue: the
        queue depth is the per-step latency of every sequence homed there,
        so the deepest queue is the fleet's p99.  The policy's per-node
        charges follow the sequence to its new device on the next decode
        graph, so no backlog is moved here."""
        self._ctx.healthy = self.pool.health.healthy(self._D)
        cands = self._ctx.candidates()
        counts = {d: 0 for d in cands}
        for st in self._p_active.values():
            counts[st["device"]] = counts.get(st["device"], 0) + 1
        src = max(counts, key=lambda d: (counts[d], -d))
        dst = min(counts, key=lambda d: (counts[d], d))
        if src == dst or counts[src] - counts[dst] < 2:
            return
        on_src = [(rid, st) for rid, st in self._p_active.items()
                  if st["device"] == src]
        # hottest = longest expected remaining stay
        rid, st = max(on_src, key=lambda kv: (
            kv[1]["req"].max_new_tokens - len(kv[1]["res"].tokens), -kv[0]))
        self._ensure_params(dst)
        self.ex.propagate_resident(src, dst, st["entry"],
                                   transport=self.runtime.transport,
                                   tag=f"serve:mig{rid}")
        self.ex.exit_data(src, st["entry"])
        st["device"] = dst
        self.migrations += 1

    def _step_pool(self) -> List[Result]:
        completed: List[Result] = []
        self._shed_out = completed
        elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        # 1. admission (placement + prefill graph)
        admits: List[Request] = []
        while len(self._p_active) + len(admits) < self.cfg.batch \
                and self._pending:
            r = self._shed_or_none(elapsed_ms)
            if r is None:
                break
            admits.append(r)
        if admits:
            self._pool_admit(admits)
        # 2. consume pending tokens; retire finished sequences
        for rid in list(self._p_active):
            st = self._p_active[rid]
            res, r = st["res"], st["req"]
            res.tokens.append(st["tok"])
            if st["tok"] == self.cfg.eos \
                    or len(res.tokens) >= r.max_new_tokens:
                self.ex.exit_data(st["device"], st["entry"])
                completed.append(res)
                del self._p_active[rid]
        # 3. tail relief: migrate a hot cache off the deepest queue
        if self.cfg.migrate_every and len(self._p_active) > 1 \
                and self._steps % self.cfg.migrate_every == 0:
            self._maybe_migrate()
        # 4. one decode TaskGraph over every live sequence
        if self._p_active:
            self._pool_decode()
        if self._p_active or completed or admits:
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
