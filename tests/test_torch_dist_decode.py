"""The port's decode serving on a distributed model and cache, on the CPU in
`gloo` worlds of 4 (one process per rank).

A SMOKE model from the port's initializer (seed 0) is placed by
`sharding.distribute_model`, its cache by `sharding.distribute_cache`, and
`make_serve_step` decodes a seeded token chain from an empty cache, the
tokens' batch rows over the data-parallel axes. Each step's logits and
next tokens are held to the same chain through the single-device
`decode_step` (which `tests/test_torch_models.py` holds to the reference)
within rtol 5e-4 / atol 5e-5 (the grid-against-one-device bar,
`tests/test_pipeline_parallel.py:54-55`; SMOKE configs are float32), the
greedy tokens equal.

The grids take every route of `layers._sharded_cached_attention`:

- (2, 2) for llama3.2-1b: batch over "data", the two KV heads over
  "model" (each rank writes its own heads);
- (1, 4): the KV heads do not divide "model", so the cache's positions
  are split four ways and each step goes through `_sdpa_merged`;
- (1, 4) with a cache of 18 positions: neither divides, the cache is
  replicated;
- recurrentgemma-9b with an 8-token local window and a 16-token cache:
  the ring cache (one KV head, so its slots split over "model") wraps
  twice in 20 steps, beside the RG-LRU states split by channel;
- xlstm-1.3b: the mLSTM / sLSTM states split by head.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_dist_helpers import grid, spawn, start_rank, stop_rank

torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5          # tests/test_pipeline_parallel.py:54-55
B = 4

# arch -> (local_window, steps, [(grid, max_len, route)]); route is where
# the first attention cache's positions / KV heads go on "model"
CASES = {
    "llama3.2-1b": (None, 10, [((2, 2), 16, "heads"),
                               ((1, 4), 16, "positions"),
                               ((1, 4), 18, "replicated")]),
    "recurrentgemma-9b": (8, 20, [((2, 2), 16, "positions"),
                                  ((1, 4), 16, "positions")]),
    "xlstm-1.3b": (None, 6, [((2, 2), 8, None), ((1, 4), 8, None)]),
}


def smoke(arch, window):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    return cfg if window is None else dataclasses.replace(
        cfg, local_window=window)


def model_of(cfg):
    from repro_torch.models import transformer as tfm
    return tfm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def one_device_chain(cfg, toks, max_len):
    """(steps, B, V) logits and (steps, B) next tokens of the decode chain
    over toks (B, steps) through the single-device `decode_step`."""
    from repro_torch.models import make_serve_step
    from repro_torch.models import transformer as tfm
    model, step = model_of(cfg), make_serve_step(cfg)
    cache = tfm.init_cache(cfg, B, max_len, device="cpu")
    logits, nxt = [], []
    for t in range(toks.shape[1]):
        n, lg, cache = step(model, cache, torch.as_tensor(toks[:, t:t + 1]))
        logits.append(lg[:, 0].numpy().copy())
        nxt.append(n[:, 0].numpy().copy())
    return np.stack(logits), np.stack(nxt)


def _route(cache):
    from torch.distributed.tensor import Shard
    for c in cache["layers"]:
        if "k" in c:
            pl = c["k"].placements
            return ("positions" if Shard(1) in pl else
                    "heads" if Shard(2) in pl else "replicated")
    return None


def _decode_rank(rank, world, init, arch, window, toks, grids, expected):
    start_rank(rank, world, init)
    try:
        from repro_torch.models import make_serve_step
        from repro_torch.models import transformer as tfm
        from repro_torch.sharding import (distribute_batch, distribute_cache,
                                          distribute_model)
        cfg = smoke(arch, window)
        step = make_serve_step(cfg)
        for (shape, max_len, route), (want_lg, want_nxt) in zip(grids,
                                                                expected):
            _, mesh = grid(shape)
            model = distribute_model(model_of(cfg), mesh)
            cache = distribute_cache(
                tfm.init_cache(cfg, B, max_len, device="cpu"), cfg, mesh)
            assert _route(cache) == route, (shape, max_len, _route(cache))
            what = f"{arch} on {shape}, {max_len} positions"
            for t in range(toks.shape[1]):
                tok = distribute_batch(
                    {"token": torch.as_tensor(toks[:, t:t + 1])},
                    mesh)["token"]
                n, lg, cache = step(model, cache, tok)
                np.testing.assert_allclose(
                    lg.full_tensor()[:, 0].numpy(), want_lg[t], rtol=RTOL,
                    atol=ATOL, err_msg=f"{what}: logits of step {t}")
                np.testing.assert_array_equal(
                    n.full_tensor()[:, 0].numpy(), want_nxt[t],
                    err_msg=f"{what}: next tokens of step {t}")
    finally:
        stop_rank()


@pytest.mark.parametrize("arch", sorted(CASES))
def test_distributed_decode_matches_one_device(tmp_path, arch):
    window, steps, grids = CASES[arch]
    cfg = smoke(arch, window)
    toks = np.random.default_rng(sum(map(ord, arch))).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int64)
    expected = [one_device_chain(cfg, toks, max_len)
                for _, max_len, _ in grids]
    spawn(_decode_rank, 4, tmp_path, arch, window, toks, grids, expected,
          timeout=120)
