"""Finds a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cell, its configuration
(whose ``file`` it gives) and its traffic mix.  Everything else is found by
name under the benchmark's directories, searched in order:

* ``traffic/<traffic>.json``: the mix's parameters and the ``driver`` that
  reads them (``drivers/<driver>.py``);
* ``cells/<workload>.json``: what is fixed per cell (the offered rate of a
  serving cell, the limits that decide ``correct``);
* ``models/<model>.py``: the architecture the configuration file names
  under ``"model"`` (its seeded leaves, the port's fields it checks, its
  model-flop terms, its kernels' shapes and its plain reference);
* ``metrics/<metric>.py``: one per-layer metric's reader.

A later change adds an architecture, a configuration, a mix, a cell or a
metric by adding files and a ``workloads`` entry; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

_MODULE_SAFE = re.compile(r"[^A-Za-z0-9_]")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict        # the configuration file's contents
    model: object       # models/<config["model"]>.py, the architecture
    traffic: dict
    cell: dict          # cells/<workload>.json
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list
    layout: "Layout"


class Layout:
    def __init__(self, root: pathlib.Path, dirs: list[pathlib.Path]):
        self.root = pathlib.Path(root)
        self.dirs = [pathlib.Path(d) for d in dirs]
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json at {self.root}")
        self.spec = json.loads(path.read_text())

    def find(self, sub: str, name: str, suffix: str) -> pathlib.Path:
        for d in self.dirs:
            p = d / sub / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def load_json(self, sub: str, name: str) -> dict:
        return json.loads(self.find(sub, name, ".json").read_text())

    def load_module(self, sub: str, name: str):
        path = self.find(sub, name, ".py")
        mod_name = f"bench_{sub}_{_MODULE_SAFE.sub('_', name)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, workload: str) -> Cell:
        spec = self.spec
        entry = next((w for w in spec["workloads"] if w["name"] == workload),
                     None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        cfg_entry = next(c for c in spec["configs"]
                         if c["name"] == entry["config"])
        config = json.loads((self.root / cfg_entry["file"]).read_text())

        def reports(metric: dict) -> bool:
            return "workloads" not in metric or workload in metric["workloads"]

        e2e = [m for m in spec["end_to_end"] if reports(m)]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if (workload in m["workloads"] if "workloads" in m
                         else m["moves"] in e2e_names)]
        return Cell(name=workload, chips=int(entry["chips"]), config=config,
                    model=self.load_module("models", config["model"]),
                    traffic=self.load_json("traffic", entry["traffic"]),
                    cell=self.load_json("cells", workload), end_to_end=e2e,
                    per_layer=per_layer, layout=self)
