"""What the benchmark loads and where it refuses to run: nothing that
``run.py`` runs loads JAX, its libraries or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's);
the reference, its model kinds included, loads nothing of the port, and
only ``program.py`` and the builders import it; the harness reads
nothing of the repository's older benchmarks; ``run.py`` exits non-zero
and prints no result without a CUDA device, and in a directory that
holds only ``BENCHMARK.json`` and the benchmark's files."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "raw2logit_tpu")


def _loaded_after(code):
    """Top-level names of the modules loaded after ``code`` runs in a
    fresh interpreter at the root of the repository."""
    probe = (f"import sys; sys.path.insert(0, {spec.ROOT!r}); {code}; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    code = ("import runpy, h100_bench.run, h100_bench.program, "
            "h100_bench.calibrate; from h100_bench import spec; "
            "c = spec.Cell('cls_train'); c.kind_module(); "
            "[c.metric_reader(m['name']) for m in c.per_layer]; "
            "spec.Cell('cls_serve').kind_module(); "
            "[spec.model_builder(k) for k in ('resnet', 'unetpp')]")
    loaded = _loaded_after(code)
    assert "raw2logit_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    code = ("import h100_bench.reference.step, h100_bench.reference.isp, "
            "h100_bench.reference.models, h100_bench.reference.ops, "
            "h100_bench.costs, h100_bench.checks, h100_bench.data; "
            "from h100_bench import spec; "
            "[spec.model_kind(k) for k in ('resnet', 'unetpp')]")
    loaded = _loaded_after(code)
    assert not loaded & {"raw2logit_tpu_torch", *FORBIDDEN}


def test_the_harness_reads_no_older_benchmark():
    for path in glob.glob(os.path.join(spec.BENCH, "**", "*.py"),
                          recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("benchmarks", "bench", "tools",
                                   "chip_smoke", *FORBIDDEN), (path, name)
        rel = os.path.relpath(path, spec.BENCH)
        if rel != "program.py" and not rel.startswith(("tests" + os.sep,
                                                       "builders" + os.sep)):
            with open(path) as fh:
                assert "raw2logit_tpu_torch" not in "".join(
                    ln for ln in fh if ln.startswith(("import", "from"))), path


def _run(cwd):
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "cls_train",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
