"""Render the dry-run and roofline tables from the dry-run JSON records
(counterpart of `repro.roofline.report`).

    PYTHONPATH=src python -m repro_torch.roofline.report \
        --dir results/dryrun_torch

The "fits" column holds args + temp per device against `HW.hbm_per_chip`
(the card's device memory), not a fixed size. Only the port's records are
read: one without `torch_version` (the reference's dry run writes the
same file names) is skipped, and the count skipped is printed to stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from .analysis import HW, default_hw, summarize_cell


def fmt_bytes(b):
    if b >= 2**30:
        return f"{b / 2**30:.2f}G"
    if b >= 2**20:
        return f"{b / 2**20:.1f}M"
    return f"{b / 2**10:.0f}K"


def fmt_s(t):
    if t == 0:
        return "0"
    if t < 1e-3:
        return f"{t * 1e6:.0f}us"
    if t < 1:
        return f"{t * 1e3:.2f}ms"
    return f"{t:.2f}s"


def load_records(d: Path, mesh: str | None = None):
    """The port's dry-run records in `d` (of `mesh` only, if given), in
    file-name order. Records without `torch_version` are not the port's:
    they are skipped, and said so once."""
    recs, foreign = [], []
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        if mesh and not r["cell"].endswith("__" + mesh):
            continue
        if "torch_version" not in r:
            foreign.append(f.name)
            continue
        recs.append(r)
    if foreign:
        print(f"[report] skipped {len(foreign)} record(s) in {d} without "
              f"torch_version, not the port's (first: {foreign[0]})",
              file=sys.stderr)
    return recs


def dryrun_table(recs, hw: Optional[HW] = None) -> str:
    hw = hw or default_hw()
    cap = f"{hw.hbm_per_chip / 1e9:.1f}G"
    rows = ["| cell | status | flops/dev | bytes/dev | "
            f"collective B/dev | args+temp GiB/dev | fits {cap} | notes |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "skipped":
            rows.append(f"| {r['cell']} | skipped | | | | | | "
                        f"{r.get('skipped', '')} |")
            continue
        if r["status"] != "ok":
            err = r.get("error", "").splitlines()[0][:120] \
                if r.get("error") else ""
            rows.append(f"| {r['cell']} | {r['status']} | | | | | | "
                        f"{err} |")
            continue
        nbytes = (r["memory"]["argument_size_in_bytes"]
                  + r["memory"]["temp_size_in_bytes"])
        fits = "yes" if nbytes <= hw.hbm_per_chip else "NO"
        notes = []
        if r.get("use_ep"):
            notes.append("EP")
        if r.get("fsdp"):
            notes.append("FSDP")
        if r.get("sequence_parallel"):
            notes.append("SP")
        if r.get("optimizer") == "adafactor":
            notes.append("adafactor")
        rows.append(
            f"| {r['cell']} | {r['status']} "
            f"| {r['cost'].get('flops', 0):.2e} "
            f"| {r['cost'].get('bytes accessed', 0):.2e} "
            f"| {fmt_bytes(r.get('collectives', {}).get('total', 0))} "
            f"| {nbytes / 2**30:.1f} | {fits} | {'+'.join(notes)} |")
    return "\n".join(rows)


def roofline_table(recs, hw: Optional[HW] = None) -> str:
    hw = hw or default_hw()
    rows = ["| cell | t_compute | t_memory | t_collective | dominant | "
            "useful (6ND/counted) | fits | next lever |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        s = summarize_cell(r, hw)
        if s is None:
            continue
        lever = {
            "compute": "reduce remat recompute / bf16 accum paths",
            "memory": "fuse passes; larger per-chip batch to amortize "
                      "weight reads",
            "collective": "reshard to cut all-gathers; overlap with "
                          "compute",
        }[s["dominant"]]
        ur = s["useful_ratio"]
        ur_s = f"{ur:.2f}" if ur == ur else "n/a"
        rows.append(
            f"| {s['cell']} | {fmt_s(s['t_compute'])} "
            f"| {fmt_s(s['t_memory'])} | {fmt_s(s['t_collective'])} "
            f"| **{s['dominant']}** | {ur_s} "
            f"| {'y' if s['fits_hbm'] else 'N'} | {lever} |")
    return "\n".join(rows)


def pick_hillclimb(recs, hw: Optional[HW] = None):
    """The hill-climb cells: worst compute fraction (train), most
    collective-bound. (None, None) where no record is ok; the first is
    None where no train record is."""
    hw = hw or default_hw()
    summaries = [s for s in (summarize_cell(r, hw) for r in recs) if s]
    if not summaries:
        return None, None
    trains = [s for s in summaries if "train" in s["cell"]]
    worst = min(trains, key=lambda s: s["t_compute"]
                / max(s["bound_s"], 1e-12)) if trains else None
    coll = max(summaries, key=lambda s: s["t_collective"]
               / max(s["bound_s"], 1e-12))
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load_records(Path(args.dir), args.mesh)
    print("## Dry-run (mesh:", args.mesh + ")\n")
    print(dryrun_table(recs))
    print("\n## Roofline\n")
    print(roofline_table(recs))
    worst, coll = pick_hillclimb(recs)
    if worst is not None:
        print(f"\nworst-compute-fraction train cell: {worst['cell']}")
    if coll is not None:
        print(f"most collective-bound cell: {coll['cell']}")


if __name__ == "__main__":
    main()
