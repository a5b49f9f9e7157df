"""Finding a cell and everything that defines it, by name.

`BENCHMARK.json` at the root of the checkout lists the cells; a cell names
a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); each per-layer metric of the cell is read by
the reader of its quantity, `layer_metrics/<quantity>.py`, for a metric
named `<quantity>` or `<quantity>.<cells>`: a quantity split by the
end-to-end metric its cells move has one reader. Nothing here knows any
cell: a cell, a mix or a metric is added by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]     # the metrics this cell reports, trace 0
    per_layer: List[dict]      # the metrics this cell reports, trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its configuration
    and traffic read from `here`."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def layer_reader(metric: str, here: Path = HERE
                 ) -> Callable[[object], Optional[float]]:
    """`read(data)` of the reader of the metric's quantity (its name
    before the first '.'): the metric's value from a traced run's data, or
    None where it finds nothing to read."""
    path = here / "layer_metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"cmax_bench_layer_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_readers(cell: Cell, here: Path = HERE) -> Dict[str, Callable]:
    return {m["name"]: layer_reader(m["name"], here)
            for m in cell.per_layer}
