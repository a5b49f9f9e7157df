"""Synthetic token pipeline for LM training/serving smoke tests and the
end-to-end training example (counterpart of `repro.data.lm`; numpy-seeded,
so every output equals the reference's exactly).

Deterministic, seedable, infinite iterator of (tokens, labels) batches with
a power-law unigram distribution plus short-range bigram structure, so the
loss actually decreases during the ~100M-model training example (pure
uniform noise would pin the loss at log(vocab)).

The serving side (`repro_torch.serving.LMDecodeWorkload`) consumes the same
distribution as variable-length chunked streams: `token_streams` splits
per-stream sequences into log-uniform `TokenChunk`s, `chunk_policy` maps
chunk lengths to padded token-length classes (the count-generic
`BucketPolicy` from data/events.py), and `fill_chunk_batch` is the LM
analogue of `events.fill_batch` — pad rows to the bucket, replicate the
batch leader into fill slots."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram power-law exponent
    repeat_prob: float = 0.35    # P(copy a recent token) -> learnable bigrams


def batches(cfg: LMDataConfig) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    V = cfg.vocab_size
    # truncated zipf over the vocab
    ranks = np.arange(1, V + 1, dtype=np.float64)
    probs = ranks ** (-cfg.zipf_a)
    probs /= probs.sum()
    while True:
        toks = rng.choice(V, size=(cfg.global_batch, cfg.seq_len + 1),
                          p=probs).astype(np.int32)
        # inject copy structure: with prob repeat_prob, token t = token t-k
        for k in (1, 2, 4):
            m = rng.random(toks.shape) < (cfg.repeat_prob / 3)
            m[:, :k] = False
            toks = np.where(m, np.roll(toks, k, axis=1), toks)
        yield toks[:, :-1], toks[:, 1:]


def one_batch(cfg: LMDataConfig) -> Tuple[np.ndarray, np.ndarray]:
    return next(batches(cfg))


# ---------------------------------------------------------------------------
# Variable-length chunked streams (the LM serving payload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenChunk:
    """A contiguous span of one stream's tokens — the request payload of
    `repro_torch.serving.LMDecodeWorkload`. `n` is the raw slot count the
    service buckets and accounts padding against (events there, tokens
    here)."""
    tokens: np.ndarray       # (n,) int32

    @property
    def n(self) -> int:
        return int(self.tokens.shape[0])


def chunk_policy(min_bucket: int = 16, max_bucket: int = 4096):
    """Token-length bucket policy for chunked LM serving. BucketPolicy is
    count-generic, so the event-window machinery applies unchanged."""
    from .events import pow2_policy
    return pow2_policy(min_bucket=min_bucket, max_bucket=max_bucket)


def chunk_lengths(n_chunks: int, n_min: int, n_max: int,
                  seed: int = 0) -> np.ndarray:
    """Heavy-tailed (log-uniform) chunk lengths, like DVS window bursts."""
    from .events import ragged_lengths
    return ragged_lengths(n_chunks, n_min, n_max, seed=seed)


def token_streams(cfg: LMDataConfig, n_streams: int,
                  chunks_per_stream: int, n_min: int, n_max: int,
                  seed: int = 0) -> Dict[str, List[TokenChunk]]:
    """Chunked token streams: `n_streams` independent zipf+copy sequences,
    each split into `chunks_per_stream` log-uniform chunks. Returned in
    stream time order — chunk k+1 continues chunk k's text, so serving
    them out of order (or against the wrong carried cache) is detectable.
    Stream ids are "lm0", "lm1", ..."""
    out: Dict[str, List[TokenChunk]] = {}
    for s in range(n_streams):
        lens = chunk_lengths(chunks_per_stream, n_min, n_max,
                             seed=seed + 31 * s)
        total = int(lens.sum())
        scfg = dataclasses.replace(cfg, seq_len=total, global_batch=1,
                                   seed=seed + 1000 + s)
        toks = one_batch(scfg)[0][0]
        chunks, off = [], 0
        for L in lens:
            chunks.append(TokenChunk(
                np.ascontiguousarray(toks[off:off + int(L)])))
            off += int(L)
        out[f"lm{s}"] = chunks
    return out


def fill_chunk_batch(chunks: Sequence[TokenChunk], bucket_n: int,
                     batch_b: int, pad_id: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Admit a partial chunk batch into a full (batch_b, bucket_n) class.

    Rows pad to `bucket_n` with `pad_id` (pad positions are never decoded,
    never read into real outputs); fill slots
    replicate the batch leader (finite, well-formed data — fill results
    are computed and discarded by the caller). Returns
    (tokens (batch_b, bucket_n) int32, lens (batch_b,) int32, n_fill).
    """
    if not chunks:
        raise ValueError("fill_chunk_batch needs at least one chunk")
    n_fill = batch_b - len(chunks)
    if n_fill < 0:
        raise ValueError(f"{len(chunks)} chunks exceed batch class "
                         f"{batch_b}")
    toks = np.full((batch_b, bucket_n), pad_id, np.int32)
    lens = np.zeros((batch_b,), np.int32)
    for i, c in enumerate(chunks):
        if c.n > bucket_n:
            raise ValueError(f"cannot pad chunk of {c.n} tokens to "
                             f"{bucket_n}")
        toks[i, :c.n] = c.tokens
        lens[i] = c.n
    if n_fill:
        toks[len(chunks):] = toks[0]
        lens[len(chunks):] = lens[0]
    return toks, lens, n_fill
