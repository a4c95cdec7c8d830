"""The port's copy of the data pipeline against the JAX package's
``repro.data``: the same batches, bit for bit, for every (seed, step), and
the prefetcher's order and restart (tests/test_substrate.py's checks)."""

import numpy as np
import pytest

import repro.data as jax_data
from repro_torch.data import (DataConfig, FileTokenSource, Prefetcher,
                              SyntheticLM, make_pipeline)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("vocab,seq,batch", [(256, 32, 2), (32000, 512, 8),
                                             (50280, 17, 3)])
def test_synthetic_batches_equal_the_reference(seed, vocab, seq, batch):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ours, ref = SyntheticLM(DataConfig(**kw)), \
        jax_data.SyntheticLM(jax_data.DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        assert a.shape == (batch, seq + 1)
        assert np.array_equal(a, b)


def test_file_source_equals_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(vocab=60000, seq_len=64, global_batch=4, seed=2,
              source=str(path))
    ours = FileTokenSource(DataConfig(**kw), str(path))
    ref = jax_data.FileTokenSource(jax_data.DataConfig(**kw), str(path))
    for step in (0, 3, 19, 20, 77):       # 78 sequences: epochs turn over
        assert np.array_equal(ours.batch_at(step)["tokens"],
                              ref.batch_at(step)["tokens"])
    pipe = make_pipeline(DataConfig(**kw), start_step=3)
    try:
        step, batch = pipe.next()
    finally:
        pipe.close()
    assert step == 3
    assert np.array_equal(batch["tokens"], ref.batch_at(3)["tokens"])


def test_synthetic_batch_deterministic_by_step():
    src = SyntheticLM(DataConfig(vocab=128, seq_len=16, global_batch=4,
                                 seed=7))
    a, b, c = (src.batch_at(s)["tokens"] for s in (3, 3, 4))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 128


def test_prefetcher_order_and_restart():
    src = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=2,
                                 seed=1))
    pf = Prefetcher(src, start_step=5, depth=2)
    steps = [pf.next()[0] for _ in range(3)]
    pf.close()
    assert steps == [5, 6, 7]
    pf2 = Prefetcher(src, start_step=6, depth=2)
    s, batch = pf2.next()
    pf2.close()
    assert s == 6
    assert np.array_equal(batch["tokens"], src.batch_at(6)["tokens"])
    assert not pf._thread.is_alive() and not pf2._thread.is_alive()


def test_make_pipeline_matches_the_reference():
    kw = dict(vocab=500, seq_len=12, global_batch=2, seed=4)
    ours = make_pipeline(DataConfig(**kw), start_step=2)
    ref = jax_data.make_pipeline(jax_data.DataConfig(**kw), start_step=2)
    try:
        for _ in range(3):
            (s1, b1), (s2, b2) = ours.next(), ref.next()
            assert s1 == s2 and np.array_equal(b1["tokens"], b2["tokens"])
    finally:
        ours.close()
        ref.close()
