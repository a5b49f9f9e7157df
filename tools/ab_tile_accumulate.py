"""Time another version of the tile kernel's source against this checkout's.

    python3 tools/ab_tile_accumulate.py OTHER.cu [--rounds 4] [--reps 50]

OTHER.cu is another version of `csrc/iwe_accum.cu` with the same C
interface, for example one taken from git history with
`git show <commit>:src/repro_torch/kernels/csrc/iwe_accum.cu`. Both are
built with the same nvcc flags, in parallel. At each stage of CONFIG, on
the inputs `chip_smoke.py` gives the kernel (B=8 POSTER windows of 40,000
events at the IMU warm start; capacity 4096 and the zero-spill capacity,
f32 and bf16 deltas), both builds must be bitwise equal to
`tile_accumulate_plain`; then they are timed with CUDA events in
alternating rounds (this, other, other, this, ...) and each build's mean
and range per launch are printed, with the card's name and power limit.
Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _build_other(path: str):
    """Start nvcc on `path`; returns (proc, library path)."""
    from repro_torch.kernels import _build
    src = open(path, "rb").read()
    h = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode())
    target = _build.BUILD_DIR / f"libab-other-{h.hexdigest()[:12]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(target), path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), target


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another version of csrc/iwe_accum.cu")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_tile_accumulate: no CUDA device available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.data import events
    from repro_torch.kernels import _build, ops, tile_accumulate, \
        tile_accumulate_plain

    proc, target = _build_other(args.other)
    this_lib = _build.load("iwe_accum")
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {args.other}:\n{log}")
    libs = {"this": this_lib, "other": ctypes.CDLL(str(target))}

    def run(which, pack):
        _build._LIBS["iwe_accum"] = libs[which]
        return tile_accumulate(pack.pix, pack.deltas, p_tile=cs.P_TILE)

    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = cmax_camel.CONFIG
    cam = cfg.camera
    specs = [dataclasses.replace(events.POSTER,
                                 n_windows=cs.WINDOWS_PER_STREAM,
                                 events_per_window=cs.N_EVENTS,
                                 n_features=cs.N_FEATURES, jerk_prob=0.0,
                                 seed=events.POSTER.seed + s)
             for s in range(cs.B_WINDOWS)]
    seqs = [events.make_sequence(sp, device=dev) for sp in specs]
    first = T.EventWindow(*[torch.stack([getattr(q[0], f)[0] for q in seqs])
                            for f in ("x", "y", "t", "p", "valid")])
    om_b = torch.stack([q[2][0] for q in seqs]).contiguous()

    print(f"[ab] this: the checkout's csrc/iwe_accum.cu; other: "
          f"{args.other}; B={cs.B_WINDOWS} N={cs.N_EVENTS}; {args.rounds} "
          f"rounds of {args.reps} launches each; on {card}")
    for st in cfg.stages:
        weights = T.sort_events(first, om_b, cam, st).weights
        cnt = cs.tile_counts(T, first, om_b, cam, st.scale)
        for cap in sorted({cs.CAPACITY, cs.zero_spill_capacity(cnt)}):
            for dtype in (torch.float32, torch.bfloat16):
                pack = ops.pack_tiles(first, om_b, cam, st.scale, weights,
                                      tile=cs.TILE, capacity=cap,
                                      dtype=dtype)
                plain = tile_accumulate_plain(pack.pix, pack.deltas,
                                              p_tile=cs.P_TILE)
                for which in libs:
                    cs.check(torch.equal(run(which, pack), plain),
                             f"{which} differs from the plain version")
                times = {w: [] for w in libs}
                for r in range(args.rounds):
                    order = ("this", "other") if r % 2 == 0 \
                        else ("other", "this")
                    for which in order:
                        times[which].append(1e3 * cs.cuda_ms(
                            lambda: run(which, pack), reps=args.reps))
                cells = ", ".join(
                    f"{w} {sum(v) / len(v):.2f} us ({min(v):.2f}-"
                    f"{max(v):.2f})" for w, v in times.items())
                print(f"[ab] s={st.scale} capacity {cap} {str(dtype)[6:]} "
                      f"tiles {pack.pix.shape[1]}: {cells}")
    _build._LIBS["iwe_accum"] = this_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
