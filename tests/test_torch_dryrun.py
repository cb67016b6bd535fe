"""The dry run on one card (``repro_torch.launch.dryrun``) against the
reference's cells on the CPU: ``input_specs`` on the ``meta`` device with
the reference's names, shapes and dtypes; every non-skipped (architecture ×
shape) cell counted on ``meta`` (the reference's abstract parameter bytes,
AdamW's moments for train, inputs, the decode cache) and priced by the
analytic step model; the CLI's records and skips equal to ``shape_cells``;
the port's step bound (``port_step_cost``) against the reference's model."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import analytic_cost as jac
from repro.launch import hlo_analysis as jha
from repro.models.model import Model as JModel
from repro_torch.configs import registry as treg
from repro_torch.core._tree import leaves as tree_leaves
from repro_torch.launch import analytic_cost as tac
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import Model
from repro_torch.models.config import param_count

torch.set_num_threads(1)      # six test workers share the CPU

ARCHS = sorted(treg.ARCHS)
CELLS = [(s.kind, s.seq, s.batch) for s in treg.SHAPES.values()] + [
    (kind, 64, 2) for kind in ("train", "prefill", "decode")]


def test_input_specs_match_the_reference_on_meta():
    for arch in ARCHS:
        tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
        for name, spec in treg.SHAPES.items():
            got = treg.input_specs(tcfg, spec)
            want = jreg.input_specs(jcfg, jreg.SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
                assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_count_their_bytes_on_meta(arch):
    cfg = treg.get_config(arch)
    total, _ = param_count(cfg)
    dtype_bytes = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    # the reference's abstract parameters: their bytes are what the port's
    # meta tree must hold (bf16 leaves, and the SSM families' per-head
    # A_log, D and dt_bias in fp32)
    jleaves = jax.tree.leaves(jax.eval_shape(JModel(jreg.get_config(arch)).init,
                                             jax.random.PRNGKey(0)))
    want_bytes = sum(int(np.prod(t.shape)) * t.dtype.itemsize for t in jleaves)
    numel = sum(t.numel() for t in tree_leaves(Model(cfg).init_abstract()))
    assert numel == sum(int(np.prod(t.shape)) for t in jleaves)
    # param_count leaves out the encoder's final norm (enc-dec): d_model
    assert 0 <= numel - total <= cfg.d_model
    wide = sum(int(np.prod(t.shape)) for t in jleaves if t.dtype.itemsize != dtype_bytes)
    assert want_bytes == numel * dtype_bytes + wide * (4 - dtype_bytes)
    for shape, status, _ in treg.shape_cells(arch):
        if status == "skip":
            continue
        rec = dryrun.lower_cell(arch, shape, device="cpu")
        ma = rec["memory_analysis"]
        assert ma["params_bytes"] == want_bytes, (arch, shape)
        assert ma["temp_bytes"] is None
        spec = treg.SHAPES[shape]
        assert (rec["mesh"], rec["chips"], rec["kind"]) == ("h100", 1, spec.kind)
        assert ma["argument_bytes"] == (ma["params_bytes"] + ma["opt_state_bytes"]
                                        + ma["input_bytes"] + ma["cache_bytes"])
        assert (ma["cache_bytes"] > 0) == (spec.kind == "decode")
        assert (ma["opt_state_bytes"] > 0) == (spec.kind == "train")
        assert rec["fits_one_card"] == (ma["argument_bytes"] <= dryrun.CARD_BYTES)
        cost = tac.step_cost(cfg, spec.kind, spec.seq, spec.batch,
                             2 if total > 100e9 else 4)
        assert (rec["hlo_flops"], rec["hlo_bytes"]) == (cost.flops, cost.hbm_bytes)
        assert set(jha.Roofline(arch, shape, "m", 1, 1.0, 1.0, 0.0, {}, 0, 1.0)
                   .to_dict()) <= set(rec)


def test_dryrun_main_writes_every_cell_and_skips_the_references(tmp_path, capsys):
    assert dryrun.main(["--all", "--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    written = sorted(p.name for p in tmp_path.iterdir())
    want, skips = [], []
    for arch in ARCHS:
        for shape, status, _ in jreg.shape_cells(arch):
            (skips if status == "skip" else want).append(f"{arch}__{shape}__h100.json")
    assert written == sorted(want)
    assert out.count("[skip]") == len(skips)
    with open(tmp_path / "mamba2-130m__long_500k__h100.json") as f:
        rec = json.load(f)
    assert rec["fits_one_card"] is True and rec["bottleneck"] == "memory"


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.lower_cell("mamba2-130m", "decode_32k")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_step_cost_drops_recompute_and_unrouted_experts(arch):
    """The port's bound: the reference's model at ``remat="none"`` (forward
    1x + backward 2x, two weight reads), less the experts a step routes to
    none of: a decode of B tokens reads min(E, B·top_k) experts' weights."""
    cfg = treg.get_config(arch)
    for kind, S, B in CELLS:
        got = tac.port_step_cost(cfg, kind, S, B)
        dense = jac.step_cost(jreg.get_config(arch).replace(remat="none"), kind, S, B)
        if cfg.family != "moe":
            assert (got.flops, got.hbm_bytes) == (dense.flops, dense.hbm_bytes)
            continue
        m = cfg.moe
        T = B * (1 if kind == "decode" else S)
        idle = m.n_experts - min(m.n_experts, T * m.top_k)
        per_expert = 3 * cfg.d_model * m.d_ff_expert        # swiglu: gate, up, down
        reads = 2 if kind == "train" else 1
        assert dense.hbm_bytes - got.hbm_bytes == \
            reads * cfg.n_layers * idle * per_expert * tac.P_BYTES
        assert (got.flops < dense.flops) == (idle > 0)
    if arch == "moonshot-v1-16b-a3b":
        rf, ref = (hlo_analysis.analyze_step(cfg, "decode", 520, 4, cost=c)
                   for c in ("port", "reference"))
        # 24 of 64 experts: the weight bytes fall by 40 experts' worth
        assert rf.hlo_bytes < ref.hlo_bytes and rf.t_memory < 0.5 * ref.t_memory
