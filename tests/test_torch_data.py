"""The port's synthetic data pipeline against the reference on the CPU:
``SyntheticLM`` gives the reference's batches bit for bit (tokens, labels and
the frontend stubs, over seeds, steps and host shardings), a restart
consumes the batches of an unbroken run, host shards assemble the global
batch, and the ``Prefetcher`` keeps its order, places batches on the device
it is given and stops its producer (or raises) on ``close``.  Ports of
``tests/test_checkpoint.py``'s pipeline tests."""
import time

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, make_pipeline

torch.set_num_threads(1)      # six test workers share the CPU

CASES = [  # (seed, step, process_index, process_count, frontend_seq, d_model, encdec)
    (0, 0, 0, 1, 0, 0, False),
    (0, 7, 1, 2, 0, 0, False),
    (3, 2, 2, 4, 0, 0, False),
    (11, 5, 0, 1, 4, 16, False),
    (11, 5, 1, 2, 6, 8, True),
    (2 ** 31 + 5, 123456, 3, 4, 3, 12, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_synthetic_batches_equal_the_reference(case):
    seed, step, pidx, pcount, front, d, encdec = case
    kw = dict(vocab=97, seq=12, global_batch=8, seed=seed, frontend_seq=front,
              d_model=d, encdec=encdec)
    mine = SyntheticLM(DataConfig(**kw), pidx, pcount).batch(step)
    ref = JSyntheticLM(JDataConfig(**kw), process_index=pidx,
                       process_count=pcount).batch(step)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and mine[k].shape == ref[k].shape
        assert mine[k].tobytes() == ref[k].tobytes(), k
    if front and d:
        assert ("enc_embeds" if encdec else "embeds") in mine


def test_defaults_are_one_process():
    src = SyntheticLM(DataConfig(vocab=11, seq=4, global_batch=3))
    assert (src.pidx, src.pcount, src.local_batch) == (0, 1, 3)
    with pytest.raises(ValueError, match="not divisible"):
        SyntheticLM(DataConfig(vocab=11, seq=4, global_batch=3), 0, 2)


def test_pipeline_resume_matches_uninterrupted():
    """Restart at step k consumes exactly the batches of an unbroken run."""
    cfg = DataConfig(vocab=97, seq=16, global_batch=4)
    full = [SyntheticLM(cfg).batch(i) for i in range(6)]
    resumed = [SyntheticLM(cfg).batch(i) for i in range(3, 6)]
    for want, got in zip(full[3:], resumed):
        np.testing.assert_array_equal(want["tokens"], got["tokens"])
        np.testing.assert_array_equal(want["labels"], got["labels"])


def test_pipeline_host_sharding_disjoint_and_deterministic():
    cfg = DataConfig(vocab=97, seq=8, global_batch=6)
    batches = [SyntheticLM(cfg, i, 3).batch(0)["tokens"] for i in range(3)]
    assert all(b.shape == (2, 8) for b in batches)
    np.testing.assert_array_equal(batches[1], SyntheticLM(cfg, 1, 3).batch(0)["tokens"])
    np.testing.assert_array_equal(np.concatenate(batches, 0),
                                  SyntheticLM(cfg, 0, 1).batch(0)["tokens"])


def test_prefetcher_orders_and_closes():
    cfg = DataConfig(vocab=11, seq=4, global_batch=2)
    src = SyntheticLM(cfg)
    pf = Prefetcher(src, start_step=2, depth=2, device="cpu", max_steps=3)
    got = list(pf)
    assert len(got) == 3
    assert all(isinstance(b["tokens"], torch.Tensor) and b["tokens"].dtype == torch.int32
               for b in got)
    np.testing.assert_array_equal(got[0]["tokens"].numpy(), src.batch(2)["tokens"])
    np.testing.assert_array_equal(got[2]["labels"].numpy(), src.batch(4)["labels"])
    pf.close()


def test_make_pipeline_places_frontend_stubs():
    cfg = DataConfig(vocab=11, seq=4, global_batch=2, seed=5, frontend_seq=3, d_model=8)
    pf = make_pipeline(cfg, start_step=1, device="cpu", max_steps=1)
    (b,) = list(pf)
    pf.close()
    want = SyntheticLM(cfg).batch(1)
    assert b["embeds"].dtype == torch.float32 and b["embeds"].shape == (2, 3, 8)
    assert b["embeds"].numpy().tobytes() == want["embeds"].tobytes()


def test_prefetcher_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Prefetcher(SyntheticLM(DataConfig(vocab=11, seq=4, global_batch=2)))


@pytest.mark.parametrize("max_steps", [None, 1])
def test_prefetcher_close_stops_blocked_producer(max_steps):
    """close() stops a producer blocked on a full queue (on a batch, or on
    the DONE sentinel) within its deadline."""
    cfg = DataConfig(vocab=11, seq=4, global_batch=2)
    pf = Prefetcher(SyntheticLM(cfg), depth=1, device="cpu", max_steps=max_steps)
    while pf._q.qsize() < 1:          # let the producer fill the queue
        time.sleep(0.001)
    pf.close(timeout=2.0)
    assert not pf._thread.is_alive()


def test_prefetcher_close_raises_on_wedged_producer():
    """A producer that cannot be joined by the deadline raises instead of
    silently leaking the thread."""

    class WedgedLM(SyntheticLM):
        def batch(self, step):
            time.sleep(1.0)           # uninterruptible mid-batch stall
            return super().batch(step)

    pf = Prefetcher(WedgedLM(DataConfig(vocab=11, seq=4, global_batch=2)), depth=1,
                    device="cpu")
    with pytest.raises(RuntimeError, match="failed to stop"):
        pf.close(timeout=0.2)
    pf._thread.join(timeout=3.0)      # it does exit once the stall ends
    assert not pf._thread.is_alive()
