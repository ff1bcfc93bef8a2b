"""The port's data pipeline on the CPU against the JAX package's.

``SyntheticTokens`` is the reference's NumPy, so its batches are held to
``repro``'s array for array. ``SyntheticEmbeddings`` draws from a
``torch.Generator`` where the reference draws from ``jax.random``, so it
is held to the reference's shapes, dtypes, scale, determinism and
(seed, step, shard) keying, not to its bits.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticEmbeddings as JaxSyntheticEmbeddings
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.data.pipeline import DataConfig, SyntheticEmbeddings, SyntheticTokens


@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 32, 8, 7), (49152, 300, 2, 0),
                                                  (512, 194, 4, 1234)])
def test_synthetic_tokens_match_jax(vocab, seq, batch, seed):
    """Every step's batch and every shard's slice, array for array; 300
    and 194 positions take the repeated-ngram windows."""
    mine = SyntheticTokens(DataConfig(vocab, seq, batch, seed=seed), device="cpu")
    ref = JaxSyntheticTokens(JaxDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 3, 1000):
        for shard, n in ((0, 1), (1, 2)):
            a, b = mine.batch_np(step, shard, n), ref.batch_np(step, shard, n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    t, j = mine.batch(5), ref.batch(5)
    for k in t:
        assert t[k].dtype == torch.int32 and t[k].device.type == "cpu"
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_data_determinism_and_sharding():
    pipe = SyntheticTokens(DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=7),
                           device="cpu")
    a, b = pipe.batch_np(step=3), pipe.batch_np(step=3)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    s0 = pipe.batch_np(step=5, shard=0, n_shards=2)["inputs"]
    s1 = pipe.batch_np(step=5, shard=1, n_shards=2)["inputs"]
    assert s0.shape[0] == s1.shape[0] == 4
    assert not np.array_equal(s0, s1)
    assert np.array_equal(a["inputs"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError):
        pipe.batch_np(step=0, n_shards=3)


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 1000), seed=st.integers(0, 99))
def test_data_property_reproducible(step, seed):
    p = SyntheticTokens(DataConfig(vocab_size=64, seq_len=16, global_batch=2, seed=seed),
                        device="cpu")
    np.testing.assert_array_equal(p.batch_np(step)["inputs"], p.batch_np(step)["inputs"])


@pytest.mark.parametrize("codebooks", [0, 4])
def test_synthetic_embeddings_against_jax(codebooks):
    """Shapes, dtypes and ranges as the reference's; the same (step, shard)
    gives the same batch, and others differ; the embeddings' scale 0.02."""
    dc = DataConfig(vocab_size=50, seq_len=64, global_batch=4, seed=3)
    mine = SyntheticEmbeddings(dc, d_model=32, num_codebooks=codebooks, device="cpu")
    ref = JaxSyntheticEmbeddings(JaxDataConfig(50, 64, 4, seed=3), 32, codebooks)
    a, j = mine.batch(2), ref.batch(2)
    for k in ("inputs", "labels"):
        assert tuple(a[k].shape) == np.shape(j[k])
        assert str(a[k].dtype).split(".")[-1] == str(np.asarray(j[k]).dtype)
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 50
    assert float(a["inputs"].std()) == pytest.approx(0.02, rel=0.05)
    assert float(a["inputs"].std()) == pytest.approx(float(np.asarray(j["inputs"]).std()),
                                                     rel=0.05)
    again = mine.batch(2)
    assert all(torch.equal(a[k], again[k]) for k in a)
    for other in (mine.batch(3), mine.batch(2, shard=1, n_shards=2)):
        assert not torch.equal(a["inputs"][:other["inputs"].shape[0]], other["inputs"])
    assert mine.batch(2, shard=1, n_shards=2)["inputs"].shape[0] == 2


def test_make_pipeline_follows_the_frontend():
    tok = make_pipeline(get_config("smollm-135m").reduced(), 16, 2, device="cpu")
    emb = make_pipeline(get_config("musicgen-medium").reduced(), 16, 2, device="cpu")
    assert isinstance(tok, SyntheticTokens) and isinstance(emb, SyntheticEmbeddings)
    assert emb.num_codebooks == get_config("musicgen-medium").num_codebooks
    b = emb.batch(0)
    assert b["labels"].shape == (2, 16, emb.num_codebooks)
    assert b["inputs"].shape == (2, 16, get_config("musicgen-medium").reduced().d_model)
    assert make_pipeline(get_config("smollm-135m"), 16, 2).device == "cuda"
