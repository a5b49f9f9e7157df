"""Render EXPERIMENTS_TORCH.md, the port's dry-run and roofline tables
(counterpart of scripts/gen_experiments.py), from the port's dry-run
records.

    PYTHONPATH=src python scripts/torch_gen_experiments.py \\
        [--dir results/dryrun_torch] [--out EXPERIMENTS_TORCH.md]

Reads only the port's records (`roofline.report.load_records` skips any
without `torch_version`); the machine is `roofline.HW()`, the H100 SXM.
Every count in the text is taken from the records. Runs on the CPU.
"""
import argparse
import sys
import textwrap
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

MESHES = (("single", "Single pod (16x16 = 256 devices)"),
          ("multi", "Two pods (2x16x16 = 512 devices)"))


def render(d: Path) -> str:
    from repro_torch.roofline.analysis import HW
    from repro_torch.roofline.report import (dryrun_table, load_records,
                                             roofline_table)
    hw = HW()
    recs = {m: load_records(d, m) for m, _ in MESHES}
    every = [r for m, _ in MESHES for r in recs[m]]
    status = Counter(r["status"] for r in every)
    versions = Counter(r.get("torch_version") for r in every)
    skips = Counter(r.get("skipped", "") for r in every
                    if r["status"] == "skipped")
    errors = sorted(r["cell"] for r in every if r["status"] == "error")
    ok = [r for r in every if r["status"] == "ok"]
    fits = sum(r["memory"]["argument_size_in_bytes"]
               + r["memory"]["temp_size_in_bytes"] <= hw.hbm_per_chip
               for r in ok)
    cap = hw.hbm_per_chip / 2**30

    def para(text: str) -> str:
        return textwrap.fill(" ".join(text.split()), 72)

    out = ["# EXPERIMENTS (PyTorch port)", "", para(f"""
Rendered by `scripts/torch_gen_experiments.py` from the port's dry-run
records in `{d}` (`python -m repro_torch.launch.dryrun --all --mesh
both`). Each cell is one (architecture x shape x mesh) step run as rank 0
of a fake process group on fake tensors, on the CPU; nothing here was
timed on a device."""), "", para(f"""
Machine (`roofline.HW()`, the H100 SXM): {hw.peak_flops / 1e12:.0f}
TFLOP/s dense bf16, {hw.hbm_bw / 1e12:.2f} TB/s HBM, {hw.link_bw / 1e9:.0f}
GB/s NVLink per device, {hw.hbm_per_chip:.0f} B ({cap:.1f} GiB) of device
memory per card. Meshes: one pod of 16x16 ("data", "model") = 256
devices; two pods of 2x16x16 ("pod", "data", "model") = 512."""), "",
           para(f"""
Cell totals: {status['ok']} ok, {status['skipped']} skipped,
{status['error']} errors ({len(every)} records). {fits} of the {len(ok)}
ok cells fit {cap:.1f} GiB per device (arguments + peak
temporaries).""")]
    for why, n in sorted(skips.items()):
        out.append(para(f"Skipped, {n} cells: {why}."))
    if errors:
        out.append(para("Errors: " + ", ".join(errors) + "."))
    out.append(para("Records by torch version: " + ", ".join(
        f"{v} ({n})" for v, n in sorted(versions.items())) + "."))
    out.append("""
## Dry run

The record's numbers are per device (rank 0), counted by the dry run's
accountant on the local shards of every op the step issues: `flops/dev`
with `torch.utils.flop_counter`'s formulas, `bytes/dev` as each op's
inputs and outputs, `collective B/dev` as each collective's output.
Every op is counted each time it runs: a loop over layers or over time
steps counts every iteration. `fits` compares arguments (parameters,
optimizer state, batch, cache) plus the peak of live temporaries per
device with the card's device memory.""")
    for m, title in MESHES:
        out.append(f"\n### {title}\n\n{dryrun_table(recs[m], hw)}")
    out.append(f"""
## Roofline

Terms per step: compute = analytic FLOPs / (devices x
{hw.peak_flops / 1e12:.0f}e12); memory = analytic HBM bytes / (devices x
{hw.hbm_bw / 1e12:.2f}e12); collective = the counted collective bytes /
(devices x {hw.link_bw / 1e9:.0f}e9). Train FLOPs count forward, backward
and remat's re-forward. `useful` = 6 N_active D / the analytic FLOPs.""")
    for m, title in MESHES:
        out.append(f"\n### {title}\n\n{roofline_table(recs[m], hw)}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--out", default="EXPERIMENTS_TORCH.md")
    args = ap.parse_args(argv)
    text = render(Path(args.dir))
    Path(args.out).write_text(text)
    print(f"wrote {args.out} ({len(text)} chars)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
