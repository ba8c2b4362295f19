"""The benchmark's manifest (``BENCHMARK.json`` at the repository's root)
and the files it names, found by name:

* a configuration ``<config>`` in ``configs/<config>.json``;
* a traffic mix ``<traffic>`` in ``traffic/<traffic>.json``, read by the
  generator of ``harness/traffic.py``;
* the mix's request kind ``<kind>`` in ``kinds/<kind>.py`` (its driver,
  its correctness numbers, its readings);
* a metric ``<metric>`` read by ``metrics/<metric>.py``'s ``read``: an
  end-to-end metric from the window (``harness.cell.Window``), a
  per-layer one from the traced window's reading
  (``harness.trace.TraceReading``);
* a cell's correctness limits in ``checks/<workload>.json``.

A later cell, mix, kind or metric is new files and entries; no file here
needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    """``BENCHMARK.json`` and the benchmark directory beside it."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def _json(self, sub: str, name: str) -> Dict:
        if not NAME_RE.match(name):
            raise ValueError(f"bad name {name!r}")
        with open(self.bench_dir / sub / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def checks(self, workload: str) -> Dict:
        return self._json("checks", workload)

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics that ``workload`` reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics that ``workload`` reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.data["per_layer"]:
            listed = m.get("workloads")
            if (listed is None and m["moves"] in e2e) or (listed and workload in listed):
                out.append(m)
        return out

    def _module(self, sub: str, name: str):
        """The module of ``<sub>/<name>.py``, loaded once."""
        if not NAME_RE.match(name):
            raise ValueError(f"bad name {name!r}")
        path = self.bench_dir / sub / f"{name}.py"
        if path not in _MODULES:
            spec = importlib.util.spec_from_file_location(
                f"benchmarks_{sub}_" + re.sub(r"\W", "_", name), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _MODULES[path] = mod
        return _MODULES[path]

    def metric_reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        return self._module("metrics", name).read

    def kind(self, name: str):
        """The request kind's module, ``kinds/<name>.py``."""
        return self._module("kinds", name)


_MODULES: Dict[Path, object] = {}


def problems(data: Dict) -> List[str]:
    """What in a manifest breaks the contract's rules of names, units and
    cross references (empty when none)."""
    out: List[str] = []

    def name_ok(kind: str, n: Optional[str]):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{kind} name {n!r}")

    configs = {c["name"] for c in data.get("configs", [])}
    for c in data.get("configs", []):
        name_ok("config", c["name"])
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
    cells = [w["name"] for w in data.get("workloads", [])]
    if len(cells) != len(set(cells)):
        out.append("duplicate workload names")
    pairs = [(w["config"], w["traffic"]) for w in data.get("workloads", [])]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    for w in data.get("workloads", []):
        name_ok("workload", w["name"])
        name_ok("config", w["config"])
        name_ok("traffic", w["traffic"])
        if w["config"] not in configs:
            out.append(f"workload {w['name']} names unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
    metrics = data.get("end_to_end", []) + data.get("per_layer", [])
    names = [m["name"] for m in metrics]
    if len(names) != len(set(names)):
        out.append("duplicate metric names")
    for m in metrics:
        name_ok("metric", m["name"])
        if not UNIT_RE.match(m.get("unit", "")):
            out.append(f"metric {m['name']} unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']} better {m.get('better')!r}")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']} lists unknown workload {w}")
    e2e = {m["name"]: m for m in data.get("end_to_end", [])}
    for m in data.get("per_layer", []):
        moved = e2e.get(m.get("moves"))
        if moved is None:
            out.append(f"per-layer {m['name']} moves unknown {m.get('moves')}")
            continue
        for w in m.get("workloads", cells):
            if w not in moved.get("workloads", cells):
                out.append(f"{m['name']} is read in {w}, which does not "
                           f"report {m['moves']}")
    for w in cells:
        reported = [m for m in data.get("end_to_end", [])
                    if w in m.get("workloads", cells)]
        if "setup_s" not in {m["name"] for m in reported} or len(reported) < 2:
            out.append(f"workload {w} lacks setup_s or another end-to-end metric")
        if not any(w in m.get("workloads", cells) for m in data.get("per_layer", [])):
            out.append(f"workload {w} reports no per-layer metric")
    return out
