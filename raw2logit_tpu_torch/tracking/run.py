"""The run store and its MLflow mirror (port of
``raw2logit_tpu/tracking/run.py``).

Runs live under ``<root>/<experiment>/<run_name>/`` with the JAX
package's layout: ``params.json``, ``metrics.jsonl`` (one JSON record per
``log_metrics``), ``state_dict.json``, and artifact directories such as
``checkpoints/``. A child run (one per fold) is a directory inside its
parent's. ``find_run``, ``list_runs`` and ``get_model_by_name`` look
recorded runs up by name.

With a tracking URI (``tracking_uri``, else ``MLFLOW_TRACKING_URI``) a
run is also mirrored to an MLflow tracking server: through the ``mlflow``
package where it is installed, otherwise, for an http(s) URI, through
the server's REST API (``tracking/mlflow_rest.py``), otherwise not at
all. The local store is always written; a mirror that fails never stops
training.
"""

import json
import os
import time

import numpy as np


def _to_jsonable(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    return v


def _safe(s):
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in s)


def run_dir(experiment_name, *run_names, root="results/runs"):
    """The directory of a run (and of its nested runs, ``run_names`` from
    the outermost), whether or not it exists."""
    return os.path.join(root, _safe(experiment_name),
                        *(_safe(n) for n in run_names))


class Run:
    def __init__(self, experiment_name, run_name, root="results/runs",
                 parent=None, tracking_uri=None):
        self.experiment_name = experiment_name
        self.run_name = run_name
        if parent is not None:
            self.dir = os.path.join(parent.dir, _safe(run_name))
        else:
            self.dir = run_dir(experiment_name, run_name, root=root)
        os.makedirs(self.dir, exist_ok=True)
        self._metrics_fh = None  # opened on the first log_metrics
        self._tracking_uri = (tracking_uri
                              or os.environ.get("MLFLOW_TRACKING_URI"))
        self._mlflow = self._mlflow_run = None
        if self._tracking_uri:
            self._start_mirror(parent)

    def _start_mirror(self, parent):
        """Mirror to ``self._tracking_uri``: the mlflow package, else REST
        for an http(s) URI, else local only; a mirror that cannot start
        leaves the run local."""
        uri = self._tracking_uri
        try:
            import mlflow
        except ImportError:
            mlflow = None
        try:
            if mlflow is not None:
                mlflow.set_tracking_uri(uri)
                mlflow.set_experiment(self.experiment_name)
                self._mlflow_run = mlflow.start_run(
                    run_name=self.run_name, nested=parent is not None)
                self._mlflow = mlflow
            elif uri.startswith(("http://", "https://")):
                from raw2logit_tpu_torch.tracking.mlflow_rest import \
                    RestMirror
                parent_mirror = parent._mlflow if parent is not None else None
                self._mlflow = self._mlflow_run = RestMirror.start(
                    uri, self.experiment_name, self.run_name,
                    parent_run_id=getattr(parent_mirror, "run_id", None))
            else:
                print("mlflow not installed — tracking locally only "
                      f"(requested URI {uri})")
        except Exception as e:  # noqa: BLE001 — never block training
            kind = "mlflow REST mirror" if mlflow is None else "mlflow mirror"
            print(f"{kind} unavailable ({e}); tracking locally")
            self._mlflow = self._mlflow_run = None

    def _mirror(self, call, *args, **kwargs):
        """``call`` on the mirror, if any; its failures are printed and
        do not reach the caller."""
        if self._mlflow is None:
            return
        try:
            getattr(self._mlflow, call)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — never block training
            print(f"mlflow mirror: {call} failed ({e})")

    def log_params(self, params):
        """Merge ``params`` into ``params.json``."""
        path = os.path.join(self.dir, "params.json")
        merged = {}
        if os.path.exists(path):
            with open(path) as fh:
                merged = json.load(fh)
        merged.update(_to_jsonable(params))
        with open(path, "w") as fh:
            json.dump(merged, fh, indent=2, default=str)
        self._mirror("log_params",
                     {k: str(v)[:250] for k, v in merged.items()})

    def log_metrics(self, metrics, step=None):
        """Append one record {time, step, **metrics} to ``metrics.jsonl``."""
        rec = {"time": time.time(), "step": step}
        rec.update({k: _to_jsonable(v) for k, v in metrics.items()})
        if self._metrics_fh is None:
            self._metrics_fh = open(
                os.path.join(self.dir, "metrics.jsonl"), "a")
        self._metrics_fh.write(json.dumps(rec, default=str) + "\n")
        self._metrics_fh.flush()
        self._mirror("log_metrics",
                     {k: float(v) for k, v in metrics.items()
                      if isinstance(v, (int, float, np.floating,
                                        np.integer))},
                     step=step)

    def log_state_dict(self, state_dict, name="state_dict.json"):
        with open(os.path.join(self.dir, name), "w") as fh:
            json.dump(_to_jsonable(state_dict), fh, indent=2, default=str)

    def artifact_dir(self, *parts):
        d = os.path.join(self.dir, *parts)
        os.makedirs(d, exist_ok=True)
        return d

    def child(self, run_name):
        """A nested run (one per fold), in a directory of this run's,
        mirrored to this run's tracking URI."""
        return Run(self.experiment_name, run_name, parent=self,
                   tracking_uri=self._tracking_uri)

    def close(self):
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None
        if self._mlflow_run is not None:
            self._mirror("end_run")
            self._mlflow_run = None

    def read_metrics(self):
        path = os.path.join(self.dir, "metrics.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            return [json.loads(line) for line in fh]


def start_run(experiment_name, run_name, **kw):
    return Run(experiment_name, run_name, **kw)


def find_run(experiment_name, run_name, root="results/runs"):
    """The recorded run ``<root>/<experiment>/<run>``; raises
    FileNotFoundError when it does not exist."""
    d = os.path.join(root, _safe(experiment_name), _safe(run_name))
    if not os.path.isdir(d):
        raise FileNotFoundError(f"run not found: {d}")
    return Run(experiment_name, run_name, root=root)


def list_runs(experiment_name, root="results/runs"):
    """The run names recorded under an experiment, sorted."""
    d = os.path.join(root, _safe(experiment_name))
    if not os.path.isdir(d):
        raise FileNotFoundError(f"experiment not found: {d}")
    return sorted(name for name in os.listdir(d)
                  if os.path.isdir(os.path.join(d, name)))


def get_model_by_name(experiment_name, run_name, root="results/runs",
                      fold=0):
    """A run's state dict and per-component checkpoint files, by names.
    The checkpoints live in the per-fold child run ``<run>_<fold>``: pass
    the parent's name and the fold, or the child's name.

    Returns (state_dict, {"processor": path or None, "classifier": path
    or None}): the port's own ``checkpoints/{processor,classifier}.pt``
    as the training CLI writes them (a static run has no processor file).
    The JAX package's orbax checkpoints are not read; weights cross over
    through ``raw2logit_tpu_torch.convert``."""
    run = find_run(experiment_name, run_name, root=root)
    child = os.path.join(run.dir, f"{_safe(run_name)}_{fold}")
    if (not os.path.isdir(os.path.join(run.dir, "checkpoints"))
            and os.path.isdir(child)):
        run.dir = child
    sd_path = os.path.join(run.dir, "state_dict.json")
    state_dict = {}
    if os.path.exists(sd_path):
        with open(sd_path) as fh:
            state_dict = json.load(fh)
    ckpts = {}
    for comp in ("processor", "classifier"):
        path = os.path.join(run.dir, "checkpoints", f"{comp}.pt")
        ckpts[comp] = path if os.path.isfile(path) else None
    return state_dict, ckpts


def display_run_info(run):
    """Print where a run's artifacts live."""
    print(f"experiment '{run.experiment_name}' > run '{run.run_name}'")
    print(f"artifacts at {os.path.abspath(run.dir)}")
