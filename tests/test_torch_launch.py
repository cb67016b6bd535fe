"""The port's ``launch/`` modules against the reference's on the CPU: the
analytic step model (``analytic_cost``) float for float on every
architecture and shape, its forward FLOPs within the reference's bands of
``FlopCounterMode`` on the port's forward, the ``Roofline`` record, and the
serving CLIs (``launch.serve``, ``examples.offload_serve``,
``examples.serve_batch``) against the reference's own CLIs driven with the
port CLI's weights, and against the engine driven directly.  The dry run
is in ``test_torch_dryrun.py`` (each file stays under
``test_fault_tolerance.py``'s 30 tests: ``--dist loadfile`` runs the largest
files first, and that file's timing test fails when it starts late)."""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.launch import analytic_cost as jac
from repro.launch import hlo_analysis as jha
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.interop import to_numpy_tree
from repro_torch.launch import analytic_cost as tac
from repro_torch.launch import hlo_analysis
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.models.config import param_count
from repro_torch.serve import ServeEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")

torch.set_num_threads(1)      # six test workers share the CPU

ARCHS = sorted(treg.ARCHS)
SMALL = ("small", 64, 2)       # (name, S, B) beside SHAPES' cells


def _cells():
    out = [(s.name, s.kind, s.seq, s.batch) for s in treg.SHAPES.values()]
    for kind in ("train", "prefill", "decode"):
        out.append((f"{SMALL[0]}_{kind}", kind, SMALL[1], SMALL[2]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_step_cost_and_forward_flops_equal_the_reference(arch):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for cfg_t, cfg_j in ((tcfg, jcfg), (treg.get_smoke_config(arch),
                                        jreg.get_smoke_config(arch))):
        for name, kind, S, B in _cells():
            for opt_bytes in (4, 2):
                got = tac.step_cost(cfg_t, kind, S, B, opt_bytes)
                want = jac.step_cost(cfg_j, kind, S, B, opt_bytes)
                assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes), \
                    (arch, name, opt_bytes)
            assert tac.forward_flops(cfg_t, B, S) == jac.forward_flops(cfg_j, B, S)
            assert tac.forward_flops(cfg_t, B, 1, decode=True, cache_len=S) == \
                jac.forward_flops(cfg_j, B, 1, decode=True, cache_len=S)
            assert tac._cache_bytes(cfg_t, B, S) == jac._cache_bytes(cfg_j, B, S)


def _counted_forward_flops(cfg, B=2, S=64) -> float:
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = treg.smoke_batch(cfg, torch.Generator().manual_seed(1), batch=B, seq=S)
    batch.pop("labels", None)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward(params, batch)
    return float(counter.get_total_flops())


def _ssm_one_chunk(cfg):
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=64))


# tests/test_analytic_cost.py's L=1 configs and bands (there against XLA's
# count, here against FlopCounterMode's: matmul-class operations only)
BANDS = {
    "minitron-4b": (lambda c: c.replace(attn_impl="dense"), 0.75, 1.35),
    "qwen2-72b": (lambda c: c.replace(attn_impl="dense"), 0.75, 1.35),
    "moonshot-v1-16b-a3b": (lambda c: c.replace(attn_impl="dense"), 0.6, 1.6),
    "mamba2-130m": (_ssm_one_chunk, 0.5, 1.6),
}


@pytest.mark.parametrize("arch", sorted(BANDS))
def test_forward_flops_sit_in_the_reference_bands_of_the_counted_forward(arch):
    adjust, lo, hi = BANDS[arch]
    cfg = adjust(treg.get_smoke_config(arch).replace(
        n_layers=1, remat="none", param_dtype="float32", compute_dtype="float32"))
    want = _counted_forward_flops(cfg)
    got = tac.forward_flops(cfg, 2, 64)
    assert lo * want < got < hi * want, (got, want)


def test_roofline_record_has_the_reference_keys():
    kw = dict(arch="a", shape="s", mesh="m", chips=1, hlo_flops=2e12, hlo_bytes=3e9,
              collective_bytes=0.0, collective_by_kind={}, collective_ops=0,
              model_flops=1e12)
    got, want = hlo_analysis.Roofline(**kw).to_dict(), jha.Roofline(**kw).to_dict()
    assert list(got) == list(want)
    assert got["t_collective_s"] == 0.0
    assert got["t_compute_s"] == 2e12 / 989e12
    assert got["t_memory_s"] == 3e9 / 3.35e12
    assert got["bottleneck"] == "compute"


@pytest.mark.parametrize("kind,seq,batch", [("decode", 528, 4), ("train", 256, 8),
                                             ("prefill", 512, 4)])
def test_analyze_step_prices_the_analytic_step_at_the_h100_roofs(kind, seq, batch):
    cfg = treg.get_config("minitron-4b")
    total, active = param_count(cfg)
    for which, model in (("port", tac.port_step_cost), ("reference", tac.step_cost)):
        rf = hlo_analysis.analyze_step(cfg, kind, seq, batch, cost=which)
        cost = model(cfg, kind, seq, batch)
        assert (rf.hlo_flops, rf.hlo_bytes) == (cost.flops, cost.hbm_bytes)
        assert rf.model_flops == jha.model_flops_for(cfg, kind, seq, batch, total, active)
        assert rf.t_bound == max(cost.flops / 989e12, cost.hbm_bytes / 3.35e12)
        assert (rf.mesh, rf.chips) == ("h100", 1)
    assert hlo_analysis.analyze_step(cfg, kind, seq, batch).hlo_flops == \
        tac.port_step_cost(cfg, kind, seq, batch).flops


def _engine_tokens(out, *, mode=None):
    cfg = out["serve_config"] if mode is None else \
        dataclasses.replace(out["serve_config"], mode=mode)
    eng = ServeEngine(out["model"], out["params"], cfg,
                      frontend_seq=out.get("frontend_seq", 0), device="cpu")
    return {rid: r.tokens for rid, r in eng.serve(out["requests"]).items()}


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m"])
def test_launch_serve_tokens_equal_the_engine_driven_directly(arch, capsys):
    out = {}
    assert tserve.main(["--arch", arch, "--requests", "5", "--max-new", "6",
                        "--device", "cpu"], out=out) == 0
    got = {rid: r.tokens for rid, r in out["results"].items()}
    assert sorted(got) == list(range(5))
    assert all(len(t) == 6 for t in got.values())
    assert got == _engine_tokens(out)
    assert "req 0:" in capsys.readouterr().out


def test_offload_serve_pool_tokens_equal_the_local_run():
    from repro_torch.examples import offload_serve
    local, pool = {}, {}
    assert offload_serve.main(["--device", "cpu"], out=local) == 0
    assert offload_serve.main(["--device", "cpu", "--pool", "--devices", "2"],
                              out=pool) == 0
    tokens = {k: {rid: r.tokens for rid, r in d["results"].items()}
              for k, d in (("local", local), ("pool", pool))}
    assert tokens["local"] == tokens["pool"]
    assert all(len(tokens["pool"][r.rid]) == r.max_new_tokens for r in pool["requests"])
    assert len(pool["evictions"]) == 2


def test_serve_batch_tokens_equal_the_wave_engine_driven_directly():
    from repro_torch.examples import serve_batch
    out = {}
    assert serve_batch.main(["--device", "cpu", "--requests", "6"], out=out) == 0
    assert out["serve_config"].mode == "wave"
    got = {rid: r.tokens for rid, r in out["results"].items()}
    assert got == _engine_tokens(out, mode="wave")
    assert got == _engine_tokens(out, mode="continuous")


# --- the serving CLIs against the reference's own CLIs ---------------------
# Each port CLI runs on the CPU in fp32; then the reference's CLI runs with
# its Model.init handing back the port CLI's weights.  A recording engine on
# both sides logs the serve config, every submit (with the results served
# before it) and every result's tokens, so the request builder, the
# submit/step schedule and the greedy tokens are held, not only the tokens.


def _fp32(get):
    return lambda arch: get(arch).replace(param_dtype="float32", compute_dtype="float32")


def _recording(engine_cls, log):
    class Recording(engine_cls):
        def __init__(self, model, params, cfg, **kw):
            log.update(params=params, frontend_seq=kw.get("frontend_seq", 0),
                       config={f: getattr(cfg, f) for f in REF_CONFIG_FIELDS},
                       submits=[], tokens={})
            super().__init__(model, params, cfg, **kw)

        def _log(self, reqs, results):
            if reqs is not None:
                log["submits"].append((len(log["tokens"]), [
                    (r.rid, [int(t) for t in r.prompt], r.max_new_tokens) for r in reqs]))
            for res in results:
                log["tokens"][res.rid] = [int(t) for t in res.tokens]

        def serve(self, reqs):          # a wave engine serves without step()
            self._log(reqs, [])
            self._serving = True
            try:
                out = super().serve(reqs)
            finally:
                self._serving = False
            self._log(None, out.values())
            return out

        def submit(self, *reqs):
            if not getattr(self, "_serving", False):
                self._log(reqs, [])
            return super().submit(*reqs)

        def step(self):
            out = super().step()
            if not getattr(self, "_serving", False):
                self._log(None, out)
            return out
    return Recording


REF_CONFIG_FIELDS = [f.name for f in dataclasses.fields(jserve.ServeConfig)]


def _ref_model(params):
    jparams = jax.tree.map(jnp.asarray, to_numpy_tree(params))

    class Given(JModel):
        def init(self, rng):
            return jparams
    return Given


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held(port, ref):
    assert port["frontend_seq"] == ref["frontend_seq"]
    assert port["submits"] == ref["submits"]
    assert port["tokens"] == ref["tokens"]
    assert sorted(port["tokens"]) == sorted(r[0] for _, rs in port["submits"] for r in rs)


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m"])
def test_launch_serve_follows_the_reference_cli(arch, monkeypatch):
    argv = ["--arch", arch, "--requests", "5", "--batch", "2", "--max-new", "5",
            "--max-len", "48", "--seed", "3"]
    port, ref = {}, {}
    monkeypatch.setattr(tserve, "ServeEngine", _recording(ServeEngine, port))
    assert tserve.main(argv + ["--dtype", "float32", "--device", "cpu"]) == 0
    monkeypatch.setattr(jserve, "get_smoke_config", _fp32(jreg.get_smoke_config))
    monkeypatch.setattr(jserve, "Model", _ref_model(port["params"]))
    monkeypatch.setattr(jserve, "ServeEngine", _recording(JServeEngine, ref))
    assert jserve.main(argv) == 0
    assert port["config"] == ref["config"]
    _held(port, ref)


def test_offload_serve_follows_the_reference_example(monkeypatch):
    """The reference's ``make_requests`` and its two-batch streaming loop
    (``examples/offload_serve.py``), local mode; the port's pool mode is
    held to its local mode in the test above."""
    from repro_torch.examples import offload_serve
    jmod = _reference_example("offload_serve")
    port, ref = {}, {}
    monkeypatch.setattr(offload_serve, "get_smoke_config", _fp32(treg.get_smoke_config))
    monkeypatch.setattr(offload_serve, "ServeEngine", _recording(ServeEngine, port))
    assert offload_serve.main(["--requests", "8", "--device", "cpu"]) == 0
    monkeypatch.setattr(jmod, "get_smoke_config", _fp32(jreg.get_smoke_config))
    monkeypatch.setattr(jmod, "Model", _ref_model(port["params"]))
    monkeypatch.setattr(jmod, "ServeEngine", _recording(JServeEngine, ref))
    monkeypatch.setattr(sys, "argv", ["offload_serve.py", "--requests", "8"])
    jmod.main()
    assert port["config"] == ref["config"]
    assert len(port["submits"]) == 2 and port["submits"][1][0] >= 2
    _held(port, ref)


def test_serve_batch_follows_the_reference_example(monkeypatch):
    """``examples/serve_batch.py``'s prompts and budgets.  Its docstring
    serves in waves while its ``ServeConfig`` keeps the default continuous
    mode; the port serves in waves, as the docstring says, and greedy
    tokens are the same in both modes."""
    from repro_torch.examples import serve_batch
    jmod = _reference_example("serve_batch")
    port, ref = {}, {}
    monkeypatch.setattr(serve_batch, "get_smoke_config", _fp32(treg.get_smoke_config))
    monkeypatch.setattr(serve_batch, "ServeEngine", _recording(ServeEngine, port))
    assert serve_batch.main(["--requests", "6", "--max-new", "5", "--device", "cpu"]) == 0
    monkeypatch.setattr(jmod, "get_smoke_config", _fp32(jreg.get_smoke_config))
    monkeypatch.setattr(jmod, "Model", _ref_model(port["params"]))
    monkeypatch.setattr(jmod, "ServeEngine", _recording(JServeEngine, ref))
    monkeypatch.setattr(sys, "argv", ["serve_batch.py", "--requests", "6", "--max-new", "5"])
    jmod.main()
    assert (port["config"].pop("mode"), ref["config"].pop("mode")) == ("wave", "continuous")
    assert port["config"] == ref["config"]
    _held(port, ref)
