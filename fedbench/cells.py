"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic and lists the per-layer metrics with the cells
that report them.  A configuration is ``configs/<config>.json``, a
traffic mix ``traffic/<traffic>.json``, what belongs to one cell alone
(the limits of its comparison) ``workloads/<cell>.json``, a per-layer
metric ``metrics/<base>.py`` and a family's plain reference
``reference/<family>.py``, where the configuration names its family.
Adding any of them is adding a file and an entry; no file is edited.

A metric's base is its name up to the first dot: ``gemm_ms.qwen2`` is
``gemm_ms`` read in the cells that report ``round_s.qwen2``, so one
reader serves a quantity split by the end-to-end metric it moves.
"""
from __future__ import annotations

import importlib
import json
import types
from pathlib import Path
from typing import List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Metric(NamedTuple):
    name: str
    unit: str
    reader: types.ModuleType


class Cell(NamedTuple):
    name: str
    chips: int
    config: types.SimpleNamespace   # the configuration file's keys
    traffic: dict                   # the traffic file's keys
    workload: dict                  # the cell's own file
    family: types.ModuleType        # reference/<family>.py
    end_to_end: List[Metric]        # (their ``reader`` is None)
    per_layer: List[Metric]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> types.SimpleNamespace:
    """A configuration's file as attributes; ``head_dim`` 0 means
    ``d_model // num_heads``."""
    cfg = _json(HERE / "configs" / f"{name}.json")
    cfg.setdefault("head_dim", 0)
    return types.SimpleNamespace(**cfg)


def family(cfg) -> types.ModuleType:
    return importlib.import_module(f"fedbench.reference.{cfg.reference}")


def reporting(entry: dict, cell: str, metrics_of_cell: List[str]) -> bool:
    """Whether a metric entry of ``BENCHMARK.json`` is reported in
    ``cell``: the cells it lists, or every cell that reports the
    end-to-end metric it moves."""
    listed = entry.get("workloads")
    if listed is not None:
        return cell in listed
    return entry["moves"] in metrics_of_cell


def base(name: str) -> str:
    """A metric's name up to its first dot: the quantity it reads."""
    return name.partition(".")[0]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it
    names."""
    bench = bench or _json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    e2e = [Metric(m["name"], m["unit"], None) for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = [m.name for m in e2e]
    per_layer = [Metric(m["name"], m["unit"], importlib.import_module(
                     f"fedbench.metrics.{base(m['name'])}"))
                 for m in bench["per_layer"] if reporting(m, name, names)]
    cfg = load_config(entry["config"])
    return Cell(name, int(entry["chips"]), cfg,
                _json(HERE / "traffic" / f"{entry['traffic']}.json"),
                _json(HERE / "workloads" / f"{name}.json"), family(cfg),
                e2e, per_layer)
