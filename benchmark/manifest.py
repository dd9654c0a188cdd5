"""Find the benchmark's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics; each part's own file sits under
``benchmark/``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the cell's correctness limits) and
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic mix or
a metric adds files and entries and edits none of this code.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Manifest:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cells(self) -> list[str]:
        return [w["name"] for w in self.data["workloads"]]

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"know {self.cells()}")

    def _json(self, *parts: str) -> dict:
        return json.loads(self.dir.joinpath(*parts).read_text())

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("workloads", f"{cell}.json")["limits"]

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: every metric without a ``workloads`` list, and those whose
        list names the cell."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
