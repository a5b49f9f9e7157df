"""The port's synthetic token pipeline (`repro_torch.data.lm`) against the
reference's: every output is numpy-seeded, so it must equal the
reference's exactly — batches, chunk lengths, chunked streams, the bucket
policy and `fill_chunk_batch`, including its errors."""
import numpy as np
import pytest

from repro.data import lm as R

from repro_torch.data import lm as P


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 16, 2),
                                                  (3, 50304, 33, 3),
                                                  (11, 128256, 8, 1)])
def test_batches_equal_the_reference(seed, vocab, seq, batch):
    rc = R.LMDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
    pc = P.LMDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
    r_it, p_it = R.batches(rc), P.batches(pc)
    for _ in range(3):
        (rt, rl), (pt, pl) = next(r_it), next(p_it)
        assert pt.dtype == rt.dtype == np.int32
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pl, rl)
    for a, b in zip(P.one_batch(pc), R.one_batch(rc)):
        np.testing.assert_array_equal(a, b)


def test_chunk_lengths_and_policy_equal_the_reference():
    for seed in range(4):
        np.testing.assert_array_equal(P.chunk_lengths(5, 8, 48, seed=seed),
                                      R.chunk_lengths(5, 8, 48, seed=seed))
    for lo, hi in [(16, 4096), (8, 64)]:
        pp, rp = P.chunk_policy(lo, hi), R.chunk_policy(lo, hi)
        assert pp.name == rp.name
        assert (pp.min_bucket, pp.max_bucket) == (rp.min_bucket,
                                                  rp.max_bucket)
        for n in (1, 7, 8, 9, 16, 17, 48, 64):
            assert pp.bucket_of(n) == rp.bucket_of(n)
        assert list(pp.classes(1, hi)) == list(rp.classes(1, hi))
        with pytest.raises(ValueError):
            pp.bucket_of(hi + 1)
        with pytest.raises(ValueError):
            rp.bucket_of(hi + 1)


@pytest.mark.parametrize("n_streams,chunks,lo,hi,seed",
                         [(4, 3, 8, 48, 0), (2, 3, 5, 14, 3)])
def test_token_streams_equal_the_reference(n_streams, chunks, lo, hi, seed):
    kw = dict(vocab_size=256, seq_len=hi, global_batch=1, seed=0)
    ps = P.token_streams(P.LMDataConfig(**kw), n_streams, chunks, lo, hi,
                         seed=seed)
    rs = R.token_streams(R.LMDataConfig(**kw), n_streams, chunks, lo, hi,
                         seed=seed)
    assert list(ps) == list(rs) == [f"lm{s}" for s in range(n_streams)]
    for sid in rs:
        assert len(ps[sid]) == len(rs[sid]) == chunks
        for a, b in zip(ps[sid], rs[sid]):
            assert isinstance(a, P.TokenChunk) and a.n == b.n
            assert a.tokens.dtype == np.int32
            np.testing.assert_array_equal(a.tokens, b.tokens)


def test_fill_chunk_batch_equals_the_reference():
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 1)]
    for batch_b in (3, 4, 8):
        for pad_id in (0, 7):
            got = P.fill_chunk_batch([P.TokenChunk(t) for t in toks], 16,
                                     batch_b, pad_id=pad_id)
            ref = R.fill_chunk_batch([R.TokenChunk(t) for t in toks], 16,
                                     batch_b, pad_id=pad_id)
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
            assert got[2] == ref[2] == batch_b - 3
            assert got[0].dtype == got[1].dtype == np.int32


@pytest.mark.parametrize("chunks_n,bucket,batch_b", [
    ([20], 16, 1),          # a chunk longer than its bucket
    ([4, 4, 4], 16, 2),     # more chunks than the batch class
    ([], 16, 2),            # no chunk at all
])
def test_fill_chunk_batch_errors_equal_the_reference(chunks_n, bucket,
                                                     batch_b):
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 256, n).astype(np.int32) for n in chunks_n]
    with pytest.raises(ValueError) as got:
        P.fill_chunk_batch([P.TokenChunk(t) for t in toks], bucket, batch_b)
    with pytest.raises(ValueError) as ref:
        R.fill_chunk_batch([R.TokenChunk(t) for t in toks], bucket, batch_b)
    assert str(got.value) == str(ref.value)
