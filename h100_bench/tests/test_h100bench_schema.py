"""BENCHMARK.json against the benchmark's contract, and the schema of the
result's last line."""

import json
import os
import re

import torch

from h100_bench import program, run, spec, trace
from h100_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = os.path.join(spec.ROOT, "BENCHMARK.json")


def _manifest():
    with open(MANIFEST) as fh:
        return json.load(fh)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_limits():
    b = _manifest()
    assert os.path.getsize(MANIFEST) <= 64 * 1024
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100_bench"]
    assert b["command"] == ["python3", "h100_bench/run.py"]
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_and_cells_have_their_files():
    b = _manifest()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.Cell(w["name"])
        assert cell.kind_module().run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits
    assert len(configs) == len({w["config"] for w in b["workloads"]})


def test_metrics_follow_the_contract():
    b = _manifest()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        layers.add(m["layer"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert os.path.exists(os.path.join(spec.BENCH, "metrics",
                                           f"{m['name']}.py"))
    assert all(_line(layer) for layer in layers)


def test_result_line_schema():
    line, _ = tiny.run_tiny("cls_serve", program)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"serve_images_per_s",
                                    "serve_batch_ms_p95", "peak_mem_gib",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_schema():
    cell = tiny.cell("cls_train")
    ms = 1_000_000
    records = [trace.Record("fused_isp_fwd_kernel<true, true>", "kernel",
                            0, 2 * ms),
               trace.Record("cudnn_conv", "kernel", 3 * ms, 9 * ms)]
    view = trace.TraceView(records, [("bench.window", 0, 10 * ms),
                                     ("bench.step", 0, 10 * ms)],
                           (0, 10 * ms), 2, {}, cell.config, cell.traffic,
                           "NVIDIA H100 80GB HBM3")
    res = run.Result()
    res.view, res.values = view, {k: 0.0 for k in cell.limits}
    line = run.result_line(cell, res, True, torch.device("cpu"), 1)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert line["device"]["busy_s"] == 0.008
    assert line["device"]["window_s"] == 0.01
    for key in ("device_ops", "idle_gaps"):
        assert 0 < len(line["breakdown"][key]) <= 10
        assert all(isinstance(n, str) and isinstance(s, float)
                   for n, s in line["breakdown"][key])
    assert list(line)[-1] == "checks"
