"""Time another version of the blur kernel's source against this checkout's.

    python3 tools/ab_blur_stats.py OTHER.cu [--rounds 4] [--reps 50]

OTHER.cu is another version of `csrc/blur_stats.cu`, for example one taken
from git history with
`git show <commit>:src/repro_torch/kernels/csrc/blur_stats.cu`, with the
`blur_sums.cuh` of the same commit beside it (a quoted #include looks in
the source's own folder first). It may have this checkout's C interface or
the earlier one (a row-block grid of `rb` rows, partial sums in device
memory and a second kernel that adds them: `blur_stats_launch(ch, fir,
partial, out, B, H, W, rb, k, stream)`, run here at rb = 16). Both are
built with the same nvcc flags, in parallel. At each stage of CONFIG, on
the channel stacks `chip_smoke.py` gives the kernel (B=8 POSTER windows of
40,000 events at the IMU warm start, capacity 4096) and on the first of
them alone (B=1, the `estimate_sequence` path), both builds must agree
with `blur_stats_streaming_plain` at the kernel's bars (sums within 1e-3 of
each window's largest, variance rtol=1e-4, max-normalized gradient
atol=1e-4) and be bitwise equal on a rerun; then they are timed with CUDA
events in alternating rounds (this, other, other, this, ...) and each
build's mean and range per launch are printed, with the card's name and
power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ab_tile_accumulate import _build_other  # noqa: E402

EARLIER_RB = 16   # rows per block of the earlier interface


def _runner(lib, name):
    """A function (channels, taps) -> (B, 8) sums through library `lib`."""
    from repro_torch.kernels import _build, blur_stats_streaming
    if not hasattr(lib, "blur_stats_smem_bytes"):   # this interface
        def run(ch, taps):
            _build._LIBS["blur_stats"] = lib
            return blur_stats_streaming(ch, taps)
        return run
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_stats_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.blur_stats_launch.restype = ctypes.c_int

    def run_earlier(ch, taps):
        B, _, H, W = ch.shape
        out = torch.empty((B, 8), dtype=torch.float32, device=ch.device)
        partial = torch.empty((B, math.ceil(H / EARLIER_RB), 8),
                              dtype=torch.float32, device=ch.device)
        err = lib.blur_stats_launch(
            ch.data_ptr(), taps.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, H, W, EARLIER_RB, taps.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out
    return run_earlier


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another version of csrc/blur_stats.cu")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_blur_stats: no CUDA device available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.data import events
    from repro_torch.kernels import _build, blur_stats_streaming_plain, ops

    proc, target = _build_other(args.other)
    this_lib = _build.load("blur_stats")
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {args.other}:\n{log}")
    runs = {"this": _runner(this_lib, "this"),
            "other": _runner(ctypes.CDLL(str(target)), "other")}

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

    print(f"[ab] this: the checkout's csrc/blur_stats.cu; other: "
          f"{args.other}; {args.rounds} rounds of {args.reps} launches "
          f"each; on {card}")
    for st in cfg.stages:
        Hs, Ws = st.grid(cam)
        weights = T.sort_events(first, om_b, cam, st).weights
        ch8 = ops.iwe_accum(first, om_b, cam, st.scale, weights=weights,
                            tile=cs.TILE, capacity=cs.CAPACITY).channels
        taps = T.gaussian_taps(st.blur_taps, st.blur_sigma, device=dev)
        for ch in (ch8, ch8[:1]):
            plain = blur_stats_streaming_plain(ch, taps)
            vp, gp = T.stats_to_objective(plain, Hs * Ws)
            for which, run in runs.items():
                out, again = run(ch, taps), run(ch, taps)
                torch.cuda.synchronize()
                rel = float(((out - plain).abs()
                             / plain.abs().amax(-1, keepdim=True)).max())
                v, g = T.stats_to_objective(out, Hs * Ws)
                rel_v = float(((v - vp).abs() / vp.abs()).max())
                err_g = float(((g - gp).abs() / gp.abs().max()).max())
                cs.check(rel <= 1e-3 and rel_v <= 1e-4 and err_g <= 1e-4,
                         f"{which} differs from the plain version: sums "
                         f"{rel}, variance {rel_v}, gradient {err_g}")
                cs.check(torch.equal(out, again),
                         f"{which} rerun is not bitwise equal")
            times = {w: [] for w in runs}
            for r in range(args.rounds):
                order = ("this", "other") if r % 2 == 0 \
                    else ("other", "this")
                for which in order:
                    times[which].append(1e3 * cs.cuda_ms(
                        lambda: runs[which](ch, taps), reps=args.reps))
            cells = ", ".join(
                f"{w} {sum(v) / len(v):.2f} us ({min(v):.2f}-"
                f"{max(v):.2f})" for w, v in times.items())
            print(f"[ab] s={st.scale} k={st.blur_taps} {Hs}x{Ws} "
                  f"B={ch.shape[0]}: {cells}")
    _build._LIBS["blur_stats"] = this_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
