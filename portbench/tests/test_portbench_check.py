"""The correctness check: the plain reference agrees with the program on
tiny float32 models, and a run whose timed path is broken underneath comes
out not correct, once for each fault a served cell can have."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from conftest import TINY_CHAT, TINY_DENSE, write_bench
from pb import cell as runner, check, reference, spec
from pb.weights import Weights


@pytest.mark.parametrize("seed", [0, 2 ** 35 + 1])
def test_reference_equals_the_program_in_float32(seed):
    from repro_torch.models import Model
    conf = TINY_DENSE
    cfg = spec.model_config(conf)
    model = Model(cfg)
    w = Weights(model.init_abstract(), conf["init"], seed, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, 37)).long()
    with torch.no_grad():
        prog, _ = model.forward(w.params, {"tokens": toks[None].int()})
    rows = torch.arange(37)
    ref = reference.logits(w.params, conf, toks, rows)
    assert torch.allclose(ref, prog[0].float(), atol=1e-4, rtol=1e-4)


def test_weights_come_from_the_seed():
    from repro_torch.models import Model
    model = Model(spec.model_config(TINY_DENSE))
    a = Weights(model.init_abstract(), TINY_DENSE["init"], 5, torch.device("cpu"))
    b = Weights(model.init_abstract(), TINY_DENSE["init"], 5, torch.device("cpu"))
    c = Weights(model.init_abstract(), TINY_DENSE["init"], 6, torch.device("cpu"))
    flat = lambda w: torch.cat([f.float() for f in w.flats.values()])   # noqa: E731
    assert torch.equal(flat(a), flat(b)) and not torch.equal(flat(a), flat(c))
    assert torch.all(a.params["final_norm"] == 0)
    b.refill(6)
    assert torch.equal(flat(b), flat(c))


def _altered_token(engine):
    """A token altered where it is produced: every sampled token + 1."""
    sample = engine._sample
    vocab = engine.model.cfg.vocab
    engine._sample = lambda logits: (sample(logits) + 1) % vocab


def _state_unchanged(engine):
    """A decode step that returns its state unchanged: the cache is put
    back as it was after every step."""
    model = engine.model
    step = model.decode_step

    def decode_step(params, token, cache, pos, **kw):
        saved = [t.clone() for t in _leaves(cache)]
        out = step(params, token, cache, pos, **kw)
        for t, s in zip(_leaves(cache), saved):
            t.copy_(s)
        return out
    model.decode_step = decode_step


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [] if tree is None else [tree]


def _break(monkeypatch, fault):
    """Break the engine that the run warms: ``fault`` gets it after its
    warm-up, before the window."""
    warm_up = runner.warm_up

    def warm_then_break(engine, *args):
        warm_up(engine, *args)
        fault(engine)
    monkeypatch.setattr(runner, "warm_up", warm_then_break)


@pytest.mark.parametrize("fault", [None, _altered_token, _state_unchanged],
                         ids=["sound", "altered_token", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    bench_dir = write_bench(tmp_path, [("tiny.cell", TINY_DENSE, TINY_CHAT)])
    c = spec.resolve_cell(spec.load_benchmark(tmp_path), "tiny.cell", tmp_path, bench_dir)
    if fault is not None:
        _break(monkeypatch, fault)
    out = runner.run(c, 1234567890123, 0.5, False, torch.device("cpu"), 0.0,
                     bench_dir=bench_dir)
    gap, limit = out["check"]["logit_gap"]
    if fault is None:
        assert out["correct"] and gap <= limit
    else:
        assert not out["correct"] and gap > limit


def test_unfinished_requests_are_failures(tmp_path, monkeypatch):
    traffic = copy.deepcopy(TINY_CHAT)
    bench_dir = write_bench(tmp_path, [("tiny.cell", TINY_DENSE, traffic)])
    c = spec.resolve_cell(spec.load_benchmark(tmp_path), "tiny.cell", tmp_path, bench_dir)

    def lose_one(engine):
        step = engine.step

        def dropping():
            return [r for r in step() if r.rid != 3]
        engine.step = dropping
    # the engine finishes request 3 but never hands it back: the run ends
    # once the engine is idle, with that request unfinished
    _break(monkeypatch, lose_one)
    out = runner.run(c, 77, 0.5, False, torch.device("cpu"), 0.0, bench_dir=bench_dir)
    assert out["failed"] == 1 and not out["correct"]


def test_sample_holds_the_longest_and_enough_tokens():
    from pb.timeline import Served
    rng = np.random.default_rng(0)
    served = [Served(i, 0.0, int(rng.integers(5, 50)), 10, done_step=i + 9,
                     tokens=list(range(10))) for i in range(30)]
    picked = check.sample(served, 2 ** 40, 35)
    longest = max(served, key=lambda s: (s.prompt_len + 10, -s.index))
    assert picked[0] is longest and sum(len(s.tokens) for s in picked) >= 35
    assert len({s.index for s in picked}) == len(picked) == 4
    assert [s.index for s in check.sample(served, 2 ** 40, 35)] == \
        [s.index for s in picked]


@pytest.mark.parametrize("seeds", [[3, 4, 5], [2 ** 33 + 6, 7, 8]])
def test_the_control_reads_a_wider_gap(seeds):
    """float8 matrix products put in the program's place pick tokens that
    lie below the float32 reference's best where the float32 program's
    never do (the chip's readings, at the cells' sizes, set the limits)."""
    from pb import control_run
    bench_dir = write_bench(conftest_tmp(), [("tiny.cell", TINY_DENSE, TINY_CHAT)])
    c = spec.resolve_cell(spec.load_benchmark(bench_dir.parent), "tiny.cell",
                          bench_dir.parent, bench_dir)
    su = runner.Setup(c, seeds[0], torch.device("cpu"))
    rows = list(control_run.readings(su, seeds, 0.5))
    assert all(r["gap"] <= 1e-4 for r in rows)
    assert max(r["control_gap"] for r in rows) > 1e-3


def conftest_tmp():
    import tempfile
    from pathlib import Path
    return Path(tempfile.mkdtemp(prefix="portbench-test-"))
