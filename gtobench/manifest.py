"""The benchmark's manifest, `BENCHMARK.json` at the root of the checkout,
and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name the manifest gives:

  - a configuration's file is the `file` of its entry (JSON: the sizes as
    they are run, and `driver`, the module under `gtobench/drivers/` that
    drives this kind of deployment);
  - a traffic mix is `gtobench/traffic/<traffic>.json`, a file of
    parameters that the configuration's driver reads;
  - a metric is `gtobench/metrics/<name>.py`, a reader with
    `read(run) -> float or None` over the record of one run;
  - the limits of the numbers that decide a cell's `correct` are
    `gtobench/limits/<workload>.json`, with the readings they were set
    from.

A cell is one entry of `workloads`; its end-to-end metrics are those of
`end_to_end` that list it (or list no cells), and its per-layer metrics
those of `per_layer` that list it, or that list no cells and move an
end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple  # the cells that report it; () for every cell of its kind
    moves: str = ""  # per-layer only: the end-to-end metric it moves
    layer: str = ""


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents, with "name" and "reduced"
    traffic: dict  # the traffic file's contents, with "name"
    limits: dict  # {number compared: its limit}, gtobench/limits/<workload>.json
    end_to_end: tuple  # Metric, ...
    per_layer: tuple  # Metric, ...


def _metric(entry: dict) -> Metric:
    return Metric(
        name=entry["name"], unit=entry["unit"], better=entry["better"], source=entry["source"],
        workloads=tuple(entry.get("workloads", ())), moves=entry.get("moves", ""),
        layer=entry.get("layer", ""),
    )


def load(root: Path) -> dict:
    """The manifest under `root` (the checkout's root)."""
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, root: Path, workload: str) -> Cell:
    """The cell named `workload`, with its configuration and traffic files
    read and its metrics picked; raises KeyError for an unknown name."""
    root = Path(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(entries)}")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = {**json.load(f), "name": cfg_entry["name"], "reduced": list(cfg_entry["reduced"])}
    with open(PACKAGE_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = {**json.load(f), "name": w["traffic"]}
    e2e = tuple(
        _metric(m) for m in manifest["end_to_end"] if not m.get("workloads") or workload in m["workloads"]
    )
    moved = {m.name for m in e2e}
    per_layer = tuple(
        _metric(m) for m in manifest["per_layer"]
        if (workload in m["workloads"] if m.get("workloads") else m["moves"] in moved)
    )
    with open(PACKAGE_DIR / "limits" / f"{workload}.json") as f:
        limits = {k: float(v) for k, v in json.load(f)["limits"].items()}
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(name: str) -> Callable:
    """`read(run)` of the metric `name`, from gtobench/metrics/<name>.py
    (the name may hold dots, so the file is loaded by its path)."""
    path = PACKAGE_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gtobench.metrics.{name.replace('.', '__')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics, run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read in `run` (a reader that finds nothing returns None,
    and the metric is left out)."""
    out = {}
    for m in metrics:
        value = reader(m.name)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def names(metrics) -> List[str]:
    return [m.name for m in metrics]
