"""Pool-mode serving (``ServeEngine(runtime=...)``) of the port against the
reference on the CPU: the counterparts of ``tests/test_serving.py``'s pool
cases, and the same runs held to the reference's pool tokens and byte
counters on gemma-7b's fp32 smoke config with the reference's weights
carried across by ``interop``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import ClusterRuntime as JClusterRuntime
from repro.core import RuntimeConfig as JRuntimeConfig
from repro.models.model import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import ClusterRuntime, KernelTable, RuntimeConfig
from repro_torch.core import _tree
from repro_torch.models import Model
from repro_torch.serve import Request, ServeConfig, ServeEngine

torch.set_num_threads(1)      # six test workers share the CPU

ARCH = "gemma-7b"
MIGRATION = ((0, (1, 2, 3), 12), (1, (4, 5), 2), (2, (6, 7, 8), 12), (3, (9, 1), 2))
# each run: (requests, ServeConfig kwargs, policy, capacity?)
RUNS = {
    "slo": ("ragged5", {"batch": 3}, "slo", False),
    "round-robin": ("ragged5", {"batch": 3}, "round-robin", False),
    "migration": ("migration", {"batch": 4, "migrate_every": 1}, "round-robin", False),
    "uncapped": ("ragged6", {"batch": 4}, None, False),
    "capped": ("ragged6", {"batch": 4}, None, True),
}


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = j_smoke(ARCH).replace(param_dtype="float32", compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH).replace(param_dtype="float32",
                                              compute_dtype="float32"))
    tp = tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _ragged(vocab, n, seed=7, lo=3, hi=12, budget=None):
    """(rid, prompt, budget) triples, as ``tests/test_serving.py:_ragged``."""
    rng = np.random.default_rng(seed)
    return [(i, [int(t) for t in rng.integers(1, vocab, rng.integers(lo, hi))],
             budget or int(rng.integers(3, 9)))
            for i in range(n)]


def _requests(which: str):
    vocab = _pair()[2].cfg.vocab
    return {"ragged5": lambda: _ragged(vocab, 5),
            "ragged6": lambda: _ragged(vocab, 6, budget=6),
            "migration": lambda: list(MIGRATION)}[which]()


def _capacity(pkg: str) -> int:
    """The reference's cap: the weights' bytes plus 1.5 sequence caches."""
    jm, jp, tm, tp = _pair()
    if pkg == "jax":
        eng = JServeEngine(jm, jp, JServeConfig(batch=4, max_len=64),
                           runtime=_jrt(None))
        try:
            cache_b = sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
                          for s in jax.tree.leaves(eng._ctpl))
        finally:
            eng.runtime.shutdown()
        param_b = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(jp))
    else:
        rt = _trt(None)
        try:
            tpl = ServeEngine(tm, tp, ServeConfig(batch=4, max_len=64), runtime=rt,
                              device="cpu")._ctpl
        finally:
            rt.shutdown()
        cache_b = sum(s.nbytes for s in _tree.leaves(tpl))
        param_b = sum(t.numel() * t.element_size() for t in _tree.leaves(tp))
    return param_b + int(1.5 * cache_b)


def _jrt(capacity):
    return JClusterRuntime(JRuntimeConfig(n_virtual=2, device_capacity_bytes=capacity))


def _trt(capacity):
    # a table of its own: the serve entries go when the runtime does
    return ClusterRuntime(RuntimeConfig(n_virtual=2, device_capacity_bytes=capacity),
                          table=KernelTable(), device="cpu")


def _summary(rt, eng, out):
    s = rt.cost.summary()
    return {"tokens": {rid: r.tokens for rid, r in out.items()},
            "timed_out": sorted(rid for rid, r in out.items() if r.timed_out),
            "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
            "bytes_peer": s["bytes_peer"], "migrations": eng.migrations,
            "memory": [{k: m[k] for k in ("evictions", "refetches")}
                       for m in rt.memory_report().values()]}


@functools.lru_cache(maxsize=None)
def _reference(run: str):
    """The reference engine's pool run ``run`` on a fresh D=2 runtime."""
    which, kw, policy, capped = RUNS[run]
    jm, jp, _, _ = _pair()
    rt = _jrt(_capacity("jax") if capped else None)
    try:
        eng = JServeEngine(jm, jp, JServeConfig(max_len=64, **kw), runtime=rt,
                           policy=policy)
        out = eng.serve([JRequest(i, list(p), n) for i, p, n in _requests(which)])
        return _summary(rt, eng, out)
    finally:
        rt.shutdown()


def _port(run: str):
    which, kw, policy, capped = RUNS[run]
    _, _, tm, tp = _pair()
    rt = _trt(_capacity("torch") if capped else None)
    try:
        eng = ServeEngine(tm, tp, ServeConfig(max_len=64, **kw), runtime=rt,
                          policy=policy, device="cpu")
        out = eng.serve([Request(i, list(p), n) for i, p, n in _requests(which)])
        return _summary(rt, eng, out)
    finally:
        rt.shutdown()


@functools.lru_cache(maxsize=None)
def _local(which: str, batch: int):
    """The port's local continuous engine on the same requests."""
    _, _, tm, tp = _pair()
    out = ServeEngine(tm, tp, ServeConfig(batch=batch, max_len=64), device="cpu").serve(
        [Request(i, list(p), n) for i, p, n in _requests(which)])
    return {rid: r.tokens for rid, r in out.items()}


@pytest.mark.parametrize("policy", ["slo", "round-robin"])
def test_pool_serving_matches_local(policy):
    """Per-sequence TaskNodes over device-resident caches give the local
    engine's greedy tokens under both placement policies, and the
    reference's pool tokens and byte counters."""
    got = _port(policy)
    assert got["tokens"] == _local("ragged5", 3)
    assert got == _reference(policy)


def test_pool_migration_rebalances_tail():
    """Round-robin parks both long sequences on device 0; once the short
    ones retire, the queue gap migrates a cache (propagate_resident over
    the funnel) and tokens stay those of the local engine, with the
    reference's migrations and bytes."""
    got = _port("migration")
    assert got["migrations"] >= 1
    assert got["tokens"] == _local("migration", 4)
    assert got == _reference("migration")


def test_capacity_lru_spill_refetch_bit_identical():
    """Capacity below the working set: cold caches spill and refetch on
    their next decode, with the uncapped run's tokens (and the reference's).
    The capped run's evictions depend on when concurrent decode regions
    release their caches: the reference read 2 per device in three idle
    runs and 2 and 4 under load (ROADMAP §3), so the capped run is held to
    the reference's own gate; the uncapped run to its counters exactly."""
    capped, uncapped = _port("capped"), _port("uncapped")
    assert sum(m["evictions"] for m in capped["memory"]) > 0
    assert sum(m["refetches"] for m in capped["memory"]) > 0
    assert capped["tokens"] == uncapped["tokens"] == _reference("capped")["tokens"]
    assert uncapped == _reference("uncapped")


def test_pool_deadline_shed_from_queue():
    """An expired queued request is shed before placement allocates it a
    cache."""
    _, _, tm, tp = _pair()
    rt = _trt(None)
    try:
        eng = ServeEngine(tm, tp, ServeConfig(batch=1, max_len=64), runtime=rt,
                          device="cpu")
        out = eng.serve([Request(0, [1, 2, 3], 6),
                         Request(1, [4, 5, 6], 6, deadline_ms=1e-3)])
        assert out[1].timed_out and out[1].tokens == []
        assert len(out[0].tokens) == 6
        for d in range(2):
            assert rt.pool.present[d].get("_serve_c1") is None
    finally:
        rt.shutdown()


def test_pool_mode_refusals():
    """The reference's refusals, and the port's device rule: the engine's
    device is the runtime pool's."""
    _, _, tm, tp = _pair()
    rt = _trt(None)
    try:
        with pytest.raises(ValueError, match="continuously"):
            ServeEngine(tm, tp, ServeConfig(mode="wave"), runtime=rt, device="cpu")
        with pytest.raises(ValueError, match="greedy"):
            ServeEngine(tm, tp, ServeConfig(temperature=1.0), runtime=rt, device="cpu")
        meta = {"w": torch.zeros(2, device="meta")}
        with pytest.raises(ValueError, match="params live on"):
            ServeEngine(tm, meta, ServeConfig(), runtime=rt, device="cpu")
        # the serve entries of one config are reused by a second engine of
        # it, and refused to a model of another config under the same name
        ServeEngine(tm, tp, ServeConfig(), runtime=rt, device="cpu")
        ServeEngine(Model(tm.cfg), tp, ServeConfig(), runtime=rt, device="cpu")
        other = Model(tm.cfg.replace(compute_dtype="bfloat16"))
        with pytest.raises(ValueError, match="another model config"):
            ServeEngine(other, tp, ServeConfig(), runtime=rt, device="cpu")
    finally:
        rt.shutdown()


def test_serve_entries_hold_no_weights():
    """The serve entries outlive the engine in their kernel table (by default
    the process-global one); they hold a parameter-free model, so the
    caller's model and its weights are freed with the engine."""
    import gc
    import weakref
    _, _, tm, tp = _pair()
    table = KernelTable()
    leaves, tdef = _tree.flatten(tp)
    params = _tree.unflatten(tdef, [t.clone() for t in leaves])
    model = Model(tm.cfg)
    model.params = params                  # as Model.init / load_numpy leave it
    alive = weakref.ref(_tree.leaves(params)[0])
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2), table=table, device="cpu")
    try:
        eng = ServeEngine(model, params, ServeConfig(batch=1, max_len=64), runtime=rt,
                          device="cpu")
        assert len(eng.serve([Request(0, [1, 2, 3], 2)])[0].tokens) == 2
    finally:
        rt.shutdown()
    del eng, rt, model, params, leaves
    gc.collect()
    assert len(table) == 2 and alive() is None
