"""The port's MLflow mirror (``tracking/mlflow_rest.py``, ``tracking.Run``)
on the cases of tests/test_tracking_mlflow.py: an in-process HTTP server
implements the tracking REST API 2.0 surface (experiments/get-by-name,
experiments/create, runs/create, runs/log-batch, runs/update) and the
mirror drives a whole run against it, with the ``mlflow`` package
hidden. Then ``MLFLOW_TRACKING_URI``, the CLI's ``--tracking_uri``, and
the port's requests against the JAX package's for the same run.
"""

import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from raw2logit_tpu.tracking import Run as JaxRun

from raw2logit_tpu_torch.data import SyntheticRawClassification
from raw2logit_tpu_torch.tracking import Run
from raw2logit_tpu_torch.tracking.mlflow_rest import (
    MAX_PARAMS_PER_BATCH, MlflowRestClient, MlflowRestError, RestMirror)
from raw2logit_tpu_torch.training import train as cli


class _Store:
    """In-memory tracking-server state, with the server's validation
    semantics: duplicate experiment names rejected, params write-once,
    log-batch entity limits enforced."""

    def __init__(self):
        self.lock = threading.Lock()
        self.experiments = {}       # name -> id
        self.runs = {}              # run_id -> record
        self.requests = []          # (method, endpoint) log
        self.fail_log_batch = False


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # silence per-request stderr lines
        pass

    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, error_code, message):
        self._reply(code, {"error_code": error_code, "message": message})

    def do_GET(self):
        store = self.server.store
        parsed = urllib.parse.urlparse(self.path)
        store.requests.append(("GET", parsed.path))
        if parsed.path == "/api/2.0/mlflow/experiments/get-by-name":
            name = urllib.parse.parse_qs(parsed.query)["experiment_name"][0]
            with store.lock:
                exp_id = store.experiments.get(name)
            if exp_id is None:
                return self._error(404, "RESOURCE_DOES_NOT_EXIST",
                                   f"no experiment {name!r}")
            return self._reply(200, {"experiment": {
                "experiment_id": exp_id, "name": name,
                "lifecycle_stage": "active"}})
        self._error(404, "ENDPOINT_NOT_FOUND", parsed.path)

    def do_POST(self):
        store = self.server.store
        store.requests.append(("POST", self.path))
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")

        if self.path == "/api/2.0/mlflow/experiments/create":
            with store.lock:
                if body["name"] in store.experiments:
                    return self._error(400, "RESOURCE_ALREADY_EXISTS",
                                       body["name"])
                exp_id = str(len(store.experiments) + 1)
                store.experiments[body["name"]] = exp_id
            return self._reply(200, {"experiment_id": exp_id})

        if self.path == "/api/2.0/mlflow/runs/create":
            with store.lock:
                run_id = f"run{len(store.runs):04d}"
                store.runs[run_id] = {
                    "experiment_id": body["experiment_id"],
                    "start_time": body.get("start_time"),
                    "tags": {t["key"]: t["value"]
                             for t in body.get("tags", [])},
                    "params": {}, "metrics": [], "status": "RUNNING",
                }
            return self._reply(200, {"run": {"info": {
                "run_id": run_id, "run_uuid": run_id,
                "experiment_id": body["experiment_id"],
                "status": "RUNNING"}}})

        if self.path == "/api/2.0/mlflow/runs/log-batch":
            if store.fail_log_batch:
                return self._error(500, "INTERNAL_ERROR", "injected")
            params = body.get("params", [])
            metrics = body.get("metrics", [])
            if (len(params) > 100 or len(metrics) > 1000
                    or len(params) + len(metrics) > 1000):
                return self._error(400, "INVALID_PARAMETER_VALUE",
                                   "batch too large")
            with store.lock:
                run = store.runs.get(body["run_id"])
                if run is None:
                    return self._error(404, "RESOURCE_DOES_NOT_EXIST",
                                       body["run_id"])
                for p in params:
                    old = run["params"].get(p["key"])
                    if old is not None and old != p["value"]:
                        return self._error(
                            400, "INVALID_PARAMETER_VALUE",
                            f"param {p['key']} already logged as {old!r}")
                    run["params"][p["key"]] = p["value"]
                for m in metrics:
                    if not {"key", "value", "timestamp"} <= set(m):
                        return self._error(400, "INVALID_PARAMETER_VALUE",
                                           f"bad metric {m}")
                    run["metrics"].append(m)
            return self._reply(200, {})

        if self.path == "/api/2.0/mlflow/runs/update":
            with store.lock:
                run = store.runs.get(body["run_id"])
                if run is None:
                    return self._error(404, "RESOURCE_DOES_NOT_EXIST",
                                       body["run_id"])
                run["status"] = body.get("status", "FINISHED")
                run["end_time"] = body.get("end_time")
            return self._reply(200, {"run_info": {
                "run_id": body["run_id"], "status": run["status"]}})

        self._error(404, "ENDPOINT_NOT_FOUND", self.path)


@pytest.fixture()
def mlflow_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.store = _Store()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", server.store
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


@pytest.fixture()
def no_mlflow_pkg(monkeypatch):
    # force the ImportError branch even if a stub was ever registered
    monkeypatch.setitem(sys.modules, "mlflow", None)


def test_run_mirrors_over_rest(tmp_path, mlflow_server, no_mlflow_pkg):
    """Full Run lifecycle (parent + per-fold child, params, stepped
    metrics, termination) lands on the tracking server via REST with the
    package absent — and local tracking still happens in parallel."""
    uri, store = mlflow_server
    run = Run("exp-rest", "parent", root=str(tmp_path), tracking_uri=uri)
    run.log_params({"lr": 1e-4, "note": "x" * 600})
    run.log_metrics({"train_loss": 1.5, "skipme": "str"}, step=3)

    child = run.child("parent_0")
    child.log_metrics({"val_loss": 0.5}, step=0)
    child.close()
    run.close()

    assert store.experiments == {"exp-rest": "1"}
    assert len(store.runs) == 2
    (pid, parent), (cid, kid) = sorted(store.runs.items())
    assert parent["tags"]["mlflow.runName"] == "parent"
    assert "mlflow.parentRunId" not in parent["tags"]
    assert kid["tags"]["mlflow.runName"] == "parent_0"
    assert kid["tags"]["mlflow.parentRunId"] == pid

    assert parent["params"]["lr"] == "0.0001"
    assert len(parent["params"]["note"]) <= 500  # server's value cap
    (m,) = parent["metrics"]
    assert (m["key"], m["value"], m["step"]) == ("train_loss", 1.5, 3)
    assert m["timestamp"] > 1e12  # epoch milliseconds
    assert kid["metrics"] == [{"key": "val_loss", "value": 0.5,
                               "timestamp": kid["metrics"][0]["timestamp"],
                               "step": 0}]
    assert parent["status"] == kid["status"] == "FINISHED"
    assert parent["end_time"] > 1e12

    # local tracking ran in parallel
    assert run.read_metrics()[0]["train_loss"] == 1.5


def test_rest_param_chunking(mlflow_server):
    """>100 params must be split across log-batch requests (the server
    rejects oversized batches) and all land."""
    uri, store = mlflow_server
    client = MlflowRestClient(uri)
    exp = client.get_or_create_experiment("chunk")
    run_id = client.create_run(exp, "r")
    client.log_batch(run_id,
                     params=[(f"p{i}", i) for i in range(250)],
                     metrics=[(f"m{i}", float(i), i) for i in range(5)])
    rec = store.runs[run_id]
    assert len(rec["params"]) == 250 and len(rec["metrics"]) == 5
    n_batches = sum(1 for m, p in store.requests
                    if p == "/api/2.0/mlflow/runs/log-batch")
    assert n_batches >= -(-250 // MAX_PARAMS_PER_BATCH)


def test_rest_experiment_reused_and_create_race(mlflow_server):
    uri, store = mlflow_server
    a = MlflowRestClient(uri)
    assert a.get_or_create_experiment("shared") == "1"
    # second client finds it instead of re-creating
    assert MlflowRestClient(uri).get_or_create_experiment("shared") == "1"
    assert sum(1 for m, p in store.requests
               if p.endswith("experiments/create")) == 1
    # losing the creation race (ALREADY_EXISTS) falls back to re-fetch
    store.experiments.pop("shared")
    try:
        probe = a.get_experiment_by_name("shared")
        assert probe is None
        store.experiments["shared"] = "1"  # raced-in by 'someone else'
        assert a.get_or_create_experiment("shared") == "1"
    finally:
        store.experiments["shared"] = "1"


def test_rest_mirror_unreachable_degrades_to_local(tmp_path, no_mlflow_pkg,
                                                   capsys):
    """Server unreachable at construction: Run falls back to local-only
    without raising (the mirror must never block training)."""
    run = Run("exp", "r", root=str(tmp_path),
              tracking_uri="http://127.0.0.1:9")  # port 9: discard proto
    assert run._mlflow is None
    assert "mlflow REST mirror unavailable" in capsys.readouterr().out
    run.log_metrics({"a": 1.0})
    run.close()
    assert run.read_metrics()[0]["a"] == 1.0


def test_rest_mirror_self_disables_after_failures(tmp_path, mlflow_server,
                                                  no_mlflow_pkg, capsys):
    """Mid-run server failures: the mirror absorbs them, disables itself
    after 3 consecutive errors, and local tracking continues."""
    uri, store = mlflow_server
    run = Run("exp", "r", root=str(tmp_path), tracking_uri=uri)
    assert isinstance(run._mlflow, RestMirror)
    store.fail_log_batch = True
    for step in range(4):
        run.log_metrics({"loss": float(step)}, step=step)
    assert run._mlflow.disabled
    assert "disabled after 3 consecutive errors" in capsys.readouterr().out
    store.fail_log_batch = False
    run.log_metrics({"loss": 9.0}, step=9)  # stays disabled, stays silent
    run.close()
    assert store.runs["run0000"]["metrics"] == []
    assert [m["loss"] for m in run.read_metrics()] == [0., 1., 2., 3., 9.]


def test_rest_error_carries_server_error_code(mlflow_server):
    uri, _ = mlflow_server
    client = MlflowRestClient(uri)
    with pytest.raises(MlflowRestError) as ei:
        client.log_batch("missing-run", metrics=[("m", 1.0, 0)])
    assert ei.value.error_code == "RESOURCE_DOES_NOT_EXIST"


def test_tracking_uri_from_the_environment(tmp_path, mlflow_server,
                                           no_mlflow_pkg, monkeypatch):
    uri, store = mlflow_server
    monkeypatch.setenv("MLFLOW_TRACKING_URI", uri)
    run = Run("env-exp", "r", root=str(tmp_path))
    assert isinstance(run._mlflow, RestMirror)
    run.log_metrics({"loss": 0.5}, step=1)
    run.close()
    assert store.experiments == {"env-exp": "1"}
    assert [m["key"] for m in store.runs["run0000"]["metrics"]] == ["loss"]
    # a URI that is not http(s) and no mlflow package: local only
    local = Run("e", "r2", root=str(tmp_path), tracking_uri="file:///x")
    assert local._mlflow is None
    local.close()


def _lifecycle(run_cls, root, uri):
    run = run_cls("exp", "parent", root=root, tracking_uri=uri)
    run.log_params({"lr": 1e-4, "layers": [1, 2]})
    run.log_metrics({"train_loss": 1.5, "acc": 0.25}, step=3)
    child = run.child("parent_0")
    child.log_metrics({"val_loss": 0.5}, step=0)
    child.close()
    run.close()


def _strip_times(store):
    """The server's records without their timestamps."""
    out = {}
    for run_id, rec in store.runs.items():
        rec = dict(rec, start_time=None, end_time=None)
        rec["metrics"] = [dict(m, timestamp=None) for m in rec["metrics"]]
        out[run_id] = rec
    return out


def test_the_port_sends_what_jax_sends(tmp_path, no_mlflow_pkg):
    """The same run through each package's Run lands as the same records,
    by the same requests."""
    stores = []
    for i, run_cls in enumerate((JaxRun, Run)):
        server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        server.store = _Store()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            _lifecycle(run_cls, str(tmp_path / str(i)),
                       f"http://127.0.0.1:{server.server_address[1]}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)
        stores.append(server.store)
    jax_store, port_store = stores
    assert port_store.requests == jax_store.requests
    assert port_store.experiments == jax_store.experiments
    assert _strip_times(port_store) == _strip_times(jax_store)


def test_cli_mirrors_to_the_tracking_uri(tmp_path, mlflow_server,
                                         no_mlflow_pkg, monkeypatch):
    """``--tracking_uri`` through the CLI on the CPU: the parent run and its
    fold land on the server with params, per-epoch metrics and FINISHED."""
    uri, store = mlflow_server
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=8, h=32, w=32, seed=5))
    cli.main(["--dataset", "SyntheticMicroscopy", "--batch_size", "4",
              "--epochs", "1", "--n_splits", "1", "--device", "cpu",
              "--tracking_uri", uri, "--experiment_name", "cli-exp",
              "--run_name", "r"])
    assert list(store.experiments) == ["cli-exp"]
    (pid, parent), (_, fold) = sorted(store.runs.items())
    assert parent["tags"]["mlflow.runName"] == "r"
    assert fold["tags"]["mlflow.runName"] == "r_0"
    assert fold["tags"]["mlflow.parentRunId"] == pid
    assert fold["params"]["dataset"] == "SyntheticMicroscopy"
    keys = {m["key"] for m in fold["metrics"]}
    assert {"train_loss", "val_loss"} <= keys
    assert parent["status"] == fold["status"] == "FINISHED"
