"""Finds what `BENCHMARK.json` names: a cell's configuration file, its traffic
mix (`traffic/<mix>.json`), the plain reference of its configuration
(`reference/<config>.py`) and each per-layer metric's reader
(`metrics/<metric>.py`); and what those files name in turn: the system family
a configuration builds (`systems/<system>.py`), the route a mix drives
through the program (`routes/<route>.py`) and the generator of its batches
(`generators/<generator>.py`). A new cell, mix, metric, route, system or
generator is new files and entries; no file here changes for it."""

from __future__ import annotations

import importlib
import importlib.util
import re
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _one(entries: List[Dict], name: str, what: str) -> Dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        known = ", ".join(e["name"] for e in entries)
        raise KeyError(f"{what} {name!r} is not in BENCHMARK.json (known: {known})")
    return found[0]


def workload(bench: Dict, name: str) -> Dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    entry = _one(bench["configs"], name, "configuration")
    conf = load_json(root / entry["file"])
    if conf.get("name") != name:
        raise ValueError(f"{entry['file']} names itself {conf.get('name')!r}, not {name!r}")
    return conf


def traffic(name: str) -> Dict:
    return load_json(PACKAGE / "traffic" / f"{name}.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _part(package: str, name: str) -> ModuleType:
    """`portbench/<package>/<name>.py`, imported as a module of its package."""
    if not MODULE_NAME.match(name) or not (PACKAGE / package / f"{name}.py").is_file():
        raise FileNotFoundError(f"portbench/{package}/{name}.py is missing")
    return importlib.import_module(f"portbench.{package}.{name}")


def system(name: str) -> ModuleType:
    """A system family's builder: `systems/<name>.py`, whose `make(conf,
    tree, seed, device)` gives (system, body, mean, std)."""
    return _part("systems", name)


def route(name: str) -> type:
    """A route's class: `routes/<name>.py`'s `ROUTE`."""
    return _part("routes", name).ROUTE


def generator(name: str) -> ModuleType:
    """A batch generator: `generators/<name>.py`, whose `batch(traffic, i)`
    makes batch i."""
    return _part("generators", name)


def reference(config_name: str) -> ModuleType:
    """The plain reference of a configuration: `reference/<config>.py`."""
    return _module(PACKAGE / "reference" / f"{config_name}.py",
                   "portbench.reference." + config_name.replace("-", "_").replace(".", "_"))


def metric_reader(metric_name: str) -> ModuleType:
    """A per-layer metric's reader: `metrics/<metric>.py`, whose `read(r)`
    gives the value or None where the run has nothing to read."""
    return _module(PACKAGE / "metrics" / f"{metric_name}.py",
                   "portbench.metrics." + metric_name.replace("-", "_").replace(".", "_"))


def cell_metrics(bench: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that a cell
    reports: those without a `workloads` key, and those that list it."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]
