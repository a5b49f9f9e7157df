"""Split the blur kernel's time into its parts with variants of its source.

    python3 tools/blur_variants.py [--reps 100]

Builds three variants of this checkout's `csrc/blur_stats.cu`, each with
one part of the work taken out by a text edit, beside the kernel itself:

  launch_only  no item is streamed: the launch, the tickets and the
               last block's sum of the (zero) partials;
  no_loads     nothing is staged or waited for: the FIRs run on whatever
               shared memory holds;
  no_firs      the band is staged and waited for, the row loop is skipped.

The variants compute wrong sums and exist only to be timed. At each stage
of CONFIG, on the channel stacks `chip_smoke.py` gives the kernel (B=8
POSTER windows of 40,000 events at the IMU warm start, capacity 4096) and
on the first of them alone (B=1), each build is timed with CUDA events
and printed with the card's name and power limit. Needs a CUDA card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ab_tile_accumulate import _build_other  # noqa: E402

# variant -> (text, replacement) edits of csrc/blur_stats.cu
EDITS = {
    "launch_only": [(
        "  stream_item<K>(chb, smem, tap, item - band * g.n_strips, band, g,"
        " lane, st,\n                 bars);", "")],
    "no_loads": [
        ("    if (g.vec)\n      stage_rows_bulk", "    if (false)\n"
         "      stage_rows_bulk"),
        ("    else\n      stage_rows<SEG>", "    else if (false)\n"
         "      stage_rows<SEG>"),
        ("    if (g.vec)\n      mbar_wait(bars + p, 0);\n    else\n"
         "      cp_async_wait(n_parts - 1 - p);", "")],
    "no_firs": [("    for (int i = p * part; i < i1; ++i) {",
                 "    for (int i = p * part; i < 0; ++i) {")],
}


def _variant_source(name: str, src: str, out_dir: str) -> str:
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"blur_variants: {name}: the source no longer "
                               f"holds {old!r}; update EDITS")
        src = src.replace(old, new)
    path = os.path.join(out_dir, f"blur_stats_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blur_variants: no CUDA device available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.data import events
    from repro_torch.kernels import _build, blur_stats_streaming, ops

    out_dir = str(_build.BUILD_DIR / "blur_variants")
    os.makedirs(out_dir, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        with open(os.path.join(out_dir, header.name), "wb") as f:
            f.write(header.read_bytes())
    src = (_build.CSRC / _build.SOURCES["blur_stats"]).read_text()
    procs = {n: _build_other(_variant_source(n, src, out_dir))
             for n in EDITS}
    libs = {"kernel": _build.load("blur_stats")}
    for name, (proc, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(target))

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
    print(f"[variants] {', '.join(libs)}; {args.reps} launches each; on "
          f"{card}")
    for st in cfg.stages:
        weights = T.sort_events(first, om_b, cam, st).weights
        ch8 = ops.iwe_accum(first, om_b, cam, st.scale, weights=weights,
                            tile=cs.TILE, capacity=cs.CAPACITY).channels
        taps = T.gaussian_taps(st.blur_taps, st.blur_sigma, device=dev)
        for ch in (ch8, ch8[:1]):
            cells = []
            for name, lib in libs.items():
                _build._LIBS["blur_stats"] = lib
                us = 1e3 * cs.cuda_ms(lambda: blur_stats_streaming(ch, taps),
                                      reps=args.reps)
                cells.append(f"{name} {us:.2f} us")
            print(f"[variants] s={st.scale} k={st.blur_taps} "
                  f"B={ch.shape[0]}: {', '.join(cells)}")
    _build._LIBS["blur_stats"] = libs["kernel"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
