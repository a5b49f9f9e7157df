"""The port's dry-run hill-climb (counterpart of scripts/perf_hillclimb.py):
re-run the three chosen cells through `repro_torch.launch.dryrun.run_cell`
with one knob at a time and print the before/after table.

    PYTHONPATH=src python scripts/torch_perf_hillclimb.py [--only H1] \\
        [--mesh single|multi] [--out results/perf_torch]

Writes <out>/<cell><variant>.json (the port's records, with
`torch_version`); a variant whose record is there is read back, so the
baseline is the cached record. Runs on the CPU on a fake process group;
no card is needed.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

OUT = "results/perf_torch"

# (cell-id, arch, shape, variants), each variant (suffix, overrides): the
# reference's plan, unchanged
PLAN = {
    # H1: 32k prefill materializes Sq x Sk attention scores; chunked
    # attention removes them
    "H1": ("deepseek-67b", "prefill_32k", [
        ("", None),                                   # baseline (cached)
        ("__chunk2048", {"attn_q_chunk": 2048}),
        ("__chunk1024", {"attn_q_chunk": 1024}),
        ("__chunk512", {"attn_q_chunk": 512}),
    ]),
    # H2: TP of a small model over 16 devices is waste; fold the model
    # axis into pure data parallelism
    "H2": ("whisper-tiny", "train_4k", [
        ("", None),
        ("__dponly", {"policy": "dp_only"}),
    ]),
    # H3: the 1T-parameter MoE: trade remat's re-forward compute for
    # memory, and trim the EP exchanges through the capacity factor
    "H3": ("kimi-k2-1t-a32b", "train_4k", [
        ("", None),
        ("__dots", {"remat_policy": "dots"}),
        ("__cap1.0", {"capacity_factor": 1.0}),
        ("__chunk1024", {"attn_q_chunk": 1024}),
        ("__mb4", {"microbatch": 4}),
        ("__mb8", {"microbatch": 8}),
        ("__mb8cap1.0", {"microbatch": 8, "capacity_factor": 1.0}),
    ]),
}


def row(suffix: str, rec: dict) -> tuple:
    """(variant, flops/dev, bytes/dev, collective B/dev, args+temp GiB)
    of an ok record."""
    mem = rec["memory"]
    return (suffix or "baseline", rec["cost"].get("flops", 0),
            rec["cost"].get("bytes accessed", 0),
            rec.get("collectives", {}).get("total", 0),
            (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
            / 2**30)


def main(argv=None, plan=None, mesh=None) -> int:
    """Run `plan` (default PLAN) on the production mesh of --mesh, or on
    DeviceMesh `mesh` (recorded under the --mesh tag); a plan entry's
    shape is a `SHAPES` name or a `ShapeSpec`. Returns 1 if a variant
    errored."""
    from repro_torch.launch.dryrun import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    n_err = 0
    for hid, (arch, shape, variants) in (plan or PLAN).items():
        if args.only and hid != args.only:
            continue
        name = shape if isinstance(shape, str) else shape.name
        spec = None if isinstance(shape, str) else shape
        print(f"\n===== {hid}: {arch} x {name} =====")
        rows = []
        for suffix, ov in variants:
            rec = run_cell(arch, name, args.mesh, out, overrides=ov,
                           tag_suffix=suffix, mesh=mesh, shape=spec)
            if rec.get("status") == "ok":
                rows.append(row(suffix, rec))
            else:
                n_err += rec.get("status") == "error"
        print(f"{'variant':14s} {'flops/dev':>12s} {'bytes/dev':>12s} "
              f"{'coll B/dev':>12s} {'args+temp GiB':>14s}")
        for variant, fl, by, co, gib in rows:
            print(f"{variant:14s} {fl:12.3e} {by:12.3e} {co:12.3e} "
                  f"{gib:14.2f}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
