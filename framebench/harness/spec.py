"""Resolve a cell by name from BENCHMARK.json: its configuration file,
its traffic mix, its limits and the metrics it reports, each found by
the name the benchmark gives it, so that a cell, a mix or a metric is
added by adding files and entries."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class SpecError(Exception):
    """The benchmark names something its files do not hold."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_reader(bench_dir: str, metric: str) -> Callable:
    """`metrics/<metric>.py`'s `read(record)`; a metric split by a
    suffix (`<quantity>.<suffix>`) without a file of its own is read by
    `metrics/<quantity>.py`."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    if not os.path.isfile(path) and "." in metric:
        path = os.path.join(bench_dir, "metrics",
                            metric.split(".")[0] + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no reader for metric {metric!r} "
                        f"({os.path.relpath(path, ROOT)})")
    spec = importlib.util.spec_from_file_location(
        "framebench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with a `workloads` list is read in those cells; one
    without, in every cell that reports the end-to-end metric it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with everything its run
    reads.  The benchmark's own files live in the directory holding this
    package (`framebench/` of the checkout)."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "framebench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names an unknown configuration "
                        f"{w['config']!r}")
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    from framebench.reference import chain
    try:
        chain.params_from(config)
    except chain.Unsupported as e:
        raise SpecError(f"configuration {w['config']!r}: {e}") from e
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    readers = {m["name"]: load_reader(bench_dir, m["name"])
               for m in per_layer}
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, readers)
