"""A stdlib REST client for an MLflow tracking server (port of
``raw2logit_tpu/tracking/mlflow_rest.py``).

Where the ``mlflow`` package is not installed and the tracking URI is an
http(s) server, ``tracking.Run`` mirrors its runs through this client,
which speaks the server's public REST API 2.0, the endpoints that
``mlflow.start_run`` / ``log_metrics`` / ``log_params`` use:

  GET  /api/2.0/mlflow/experiments/get-by-name
  POST /api/2.0/mlflow/experiments/create
  POST /api/2.0/mlflow/runs/create      (mlflow.runName / parentRunId tags)
  POST /api/2.0/mlflow/runs/log-batch   (chunked to the server limits)
  POST /api/2.0/mlflow/runs/update      (terminate with status/end_time)

``tests/test_torch_tracking_mlflow.py`` drives it against an in-process
HTTP server that implements the protocol.
"""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

# the MLflow server rejects log-batch payloads beyond these
# (mlflow.utils.validation): 1000 metrics, 100 params, 1000 total
MAX_PARAMS_PER_BATCH = 100
MAX_METRICS_PER_BATCH = 1000
PARAM_VALUE_MAX_LEN = 500


class MlflowRestError(RuntimeError):
    def __init__(self, message, error_code=None):
        super().__init__(message)
        self.error_code = error_code


class MlflowRestClient:
    """Thin, synchronous client for the endpoints the mirror needs."""

    def __init__(self, uri, timeout=5.0):
        self.base = uri.rstrip("/")
        self.timeout = timeout

    def _call(self, method, endpoint, payload=None, query=None):
        url = f"{self.base}/api/2.0/mlflow/{endpoint}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = (json.dumps(payload).encode("utf-8")
                if payload is not None else None)
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read().decode("utf-8")
                return json.loads(body) if body.strip() else {}
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", errors="replace")
            try:
                err = json.loads(body)
            except ValueError:
                err = {"error_code": f"HTTP_{e.code}", "message": body[:200]}
            raise MlflowRestError(
                f"{endpoint}: {err.get('error_code')}: {err.get('message')}",
                error_code=err.get("error_code")) from None
        except OSError as e:  # connection refused, timeout, DNS...
            raise MlflowRestError(f"{endpoint}: {e}") from None

    def get_experiment_by_name(self, name):
        """Experiment id or None (RESOURCE_DOES_NOT_EXIST -> None)."""
        try:
            resp = self._call("GET", "experiments/get-by-name",
                              query={"experiment_name": name})
        except MlflowRestError as e:
            if e.error_code == "RESOURCE_DOES_NOT_EXIST":
                return None
            raise
        return resp["experiment"]["experiment_id"]

    def get_or_create_experiment(self, name):
        exp_id = self.get_experiment_by_name(name)
        if exp_id is not None:
            return exp_id
        try:
            return self._call("POST", "experiments/create",
                              {"name": name})["experiment_id"]
        except MlflowRestError as e:
            # lost a creation race with another process — re-fetch
            if e.error_code == "RESOURCE_ALREADY_EXISTS":
                exp_id = self.get_experiment_by_name(name)
                if exp_id is not None:
                    return exp_id
            raise

    def create_run(self, experiment_id, run_name, parent_run_id=None):
        tags = [{"key": "mlflow.runName", "value": run_name}]
        if parent_run_id is not None:
            tags.append({"key": "mlflow.parentRunId",
                         "value": parent_run_id})
        resp = self._call("POST", "runs/create", {
            "experiment_id": experiment_id,
            "run_name": run_name,
            "start_time": int(time.time() * 1000),
            "tags": tags,
        })
        return resp["run"]["info"]["run_id"]

    def log_batch(self, run_id, params=(), metrics=()):
        """params: [(key, value)]; metrics: [(key, float, step-or-None)].
        Chunked to the server's per-request entity limits."""
        now_ms = int(time.time() * 1000)
        params = [{"key": str(k), "value": str(v)[:PARAM_VALUE_MAX_LEN]}
                  for k, v in params]
        metrics = [{"key": str(k), "value": float(v),
                    "timestamp": now_ms, "step": int(step or 0)}
                   for k, v, step in metrics]
        while params or metrics:
            p, params = (params[:MAX_PARAMS_PER_BATCH],
                         params[MAX_PARAMS_PER_BATCH:])
            room = MAX_METRICS_PER_BATCH - len(p)
            m, metrics = metrics[:room], metrics[room:]
            body = {"run_id": run_id}
            if p:
                body["params"] = p
            if m:
                body["metrics"] = m
            self._call("POST", "runs/log-batch", body)

    def set_terminated(self, run_id, status="FINISHED"):
        self._call("POST", "runs/update", {
            "run_id": run_id, "status": status,
            "end_time": int(time.time() * 1000)})


class RestMirror:
    """Duck-typed to the slice of the mlflow-module surface ``Run`` uses
    (log_params / log_metrics / end_run), backed by MlflowRestClient.

    Post-construction failures NEVER propagate (the mirror must not
    block training): after ``max_failures`` consecutive errors the
    mirror disables itself and says so once. Construction failures DO
    raise, so Run's setup falls back to local-only tracking."""

    def __init__(self, client, run_id, max_failures=3):
        self.client = client
        self.run_id = run_id
        self.max_failures = max_failures
        self._failures = 0
        self.disabled = False

    @classmethod
    def start(cls, uri, experiment_name, run_name, parent_run_id=None,
              timeout=5.0):
        client = MlflowRestClient(uri, timeout=timeout)
        exp_id = client.get_or_create_experiment(experiment_name)
        run_id = client.create_run(exp_id, run_name,
                                   parent_run_id=parent_run_id)
        return cls(client, run_id)

    def _guard(self, fn):
        if self.disabled:
            return
        try:
            fn()
            self._failures = 0
        except MlflowRestError as e:
            self._failures += 1
            if self._failures >= self.max_failures:
                self.disabled = True
                print(f"mlflow REST mirror disabled after "
                      f"{self._failures} consecutive errors ({e}); "
                      "tracking locally")

    def log_params(self, params):
        self._guard(lambda: self.client.log_batch(
            self.run_id, params=list(params.items())))

    def log_metrics(self, metrics, step=None):
        self._guard(lambda: self.client.log_batch(
            self.run_id,
            metrics=[(k, v, step) for k, v in metrics.items()]))

    def end_run(self, status="FINISHED"):
        self._guard(lambda: self.client.set_terminated(self.run_id,
                                                       status=status))
