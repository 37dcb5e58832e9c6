"""Finds everything by name: ``BENCHMARK.json`` at the root of the
checkout names the cells and metrics; a cell's files are
``h100_bench/cells/<cell>.json`` (its limits), its configuration's
``h100_bench/configs/<config>.json`` and its traffic mix's
``h100_bench/traffic/<mix>.json``, whose ``kind`` names the generator
``h100_bench/traffic/<kind>.py``; the configuration's ``model.kind``
names the task model's reference ``h100_bench/reference/kinds/<kind>.py``
and its builder in the port ``h100_bench/builders/<kind>.py``; a
per-layer metric is ``h100_bench/metrics/<metric>.py``. A new cell,
configuration, mix, model kind or metric is a new file and a new entry;
no file here needs an edit."""

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# model kind -> the benchmark directory its files come from: that of the
# last ``Cell`` whose configuration uses it, else this one
_KIND_BENCH = {}
_KIND_PARTS = (("reference", "kinds"), ("builders",))


def _load(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One cell: its entry in ``BENCHMARK.json``, its configuration, its
    mix (with ``kind``), its limits, and the metrics it reports."""

    def __init__(self, name, root=ROOT, bench=BENCH):
        self.bench = bench
        manifest = _load(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        self.name, self.entry = name, entries[name]
        self.config = _load(os.path.join(bench, "configs",
                                         f"{self.entry['config']}.json"))
        self.traffic = _load(os.path.join(bench, "traffic",
                                          f"{self.entry['traffic']}.json"))
        self.file = _load(os.path.join(bench, "cells", f"{name}.json"))
        _kind_paths(self.config["model"]["kind"], bench)
        _KIND_BENCH[self.config["model"]["kind"]] = bench
        self.limits = self.file["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if self._reports(m, ())]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if self._reports(m, moved)]

    def _reports(self, metric, moved):
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return not moved or metric.get("moves") in moved

    def kind_module(self):
        return _module(os.path.join(self.bench, "traffic",
                                    f"{self.traffic['kind']}.py"),
                       f"h100_bench.traffic.{self.traffic['kind']}")

    def metric_reader(self, name):
        return _module(os.path.join(self.bench, "metrics", f"{name}.py"),
                       f"h100_bench.metrics.{name}").read


def _kind_paths(kind, bench):
    """(reference file, builder file) of model kind ``kind`` under
    ``bench``; a kind that lacks either fails here, naming both."""
    paths = [os.path.join(bench, *part, f"{kind}.py")
             for part in _KIND_PARTS]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise LookupError(f"model kind {kind!r} is the reference "
                          f"{paths[0]} and the builder {paths[1]}; "
                          f"missing: {', '.join(missing)}")
    return paths


def _kind_module(kind, part):
    return _module(_kind_paths(kind, _KIND_BENCH.get(kind, BENCH))[part],
                   ".".join(("h100_bench", *_KIND_PARTS[part], kind)))


def model_kind(kind):
    """The reference module of model kind ``kind``: ``spec(model)``,
    ``forward(model, p, x, train, tf32)``, ``macs(model, height,
    width)``, in plain PyTorch."""
    return _kind_module(kind, 0)


def model_builder(kind):
    """The builder module of model kind ``kind``: ``build(model,
    device)``, the port's module."""
    return _kind_module(kind, 1)


def _module(path, name):
    """The module at ``path`` (metric files carry dots in their names, so
    they are loaded from their paths)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def camera(config):
    """(black level, white balance, colour matrix) of a configuration."""
    cam = config["camera"]
    return cam["black_level"], cam["white_balance"], cam["colour_matrix"]
