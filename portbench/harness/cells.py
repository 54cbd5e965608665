"""The benchmark's manifest and the files it names.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`), each
naming a configuration and a traffic mix, and the metrics. Everything that
belongs to one configuration, mix or per-layer metric is a file of its own,
found here by its name:
  - configuration `<c>`: `portbench/configs/<c>.json` (the path in the
    manifest's `configs[].file`), and its operation and byte counts in
    `portbench/counts/<c>.py`;
  - traffic mix `<t>`: `portbench/traffic/<t>.json`, parameters that the
    loops of `harness/loops.py` read;
  - per-layer metric `<m>`: `portbench/metrics/<m>.py`, its reader.
Adding a cell, a configuration, a mix or a metric adds files and manifest
entries; no file here changes.
"""
import importlib.util
import json
import os

__all__ = ["ROOT", "BENCH", "Cell", "load_manifest", "load_module"]

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path, name):
    """A Python file loaded by path (metric and count files carry dots in
    their names, so they are not importable by module name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    count file and metric readers resolved from the files they name."""

    def __init__(self, name, root=ROOT, bench=BENCH):
        self.manifest = load_manifest(root)
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = [c for c in self.manifest["configs"]
                     if c["name"] == self.workload["config"]][0]
        with open(os.path.join(root, cfg_entry["file"])) as f:
            self.config = json.load(f)
        traffic = self.workload["traffic"]
        with open(os.path.join(bench, "traffic", traffic + ".json")) as f:
            self.traffic = json.load(f)
        self.counts = load_module(
            os.path.join(bench, "counts", self.workload["config"] + ".py"),
            "portbench_counts_" + self.workload["config"].replace(".", "_"))
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.readers = {
            m["name"]: load_module(
                os.path.join(bench, "metrics", m["name"] + ".py"),
                "portbench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}
