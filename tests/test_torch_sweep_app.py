"""The port's sweep (``python -m raw2logit_tpu_torch.training.sweep``) and
demo app (``python -m raw2logit_tpu_torch.app``) against the JAX
package's: the grid job for job, the dry run's shards, the manifest and
its ``--resume``; ``process`` for every choice of the form on the same
mosaic, the 8-bit and RGB uploads, and the HTTP round trip.
"""

import io
import json
import os
import stat
import sys
import threading
import urllib.request
import uuid

import numpy as np
import pytest
import torch
from PIL import Image

import app as jax_app
from raw2logit_tpu.training import sweep as jsweep

from raw2logit_tpu_torch import app
from raw2logit_tpu_torch.training import sweep

# --- sweep ------------------------------------------------------------------


def test_grid_is_jax_s():
    args = (["SyntheticMicroscopy", "SyntheticDrone"], ["weak", "none"], 3,
            8, 1e-4, 2, ("--precompute_static",))
    port, jax_jobs = sweep.build_grid(*args), jsweep.build_grid(*args)
    assert len(port) == len(jax_jobs) == 48
    assert port == jax_jobs


def test_dry_run_shards_and_passes_the_device(capsys):
    jobs = sweep.build_grid(["SyntheticMicroscopy"], ["weak"], 1, 4, 1e-5, 1)
    manifest = sweep.run_sweep(jobs, shard=1, n_shards=4, dry_run=True,
                               device="cpu")
    printed = capsys.readouterr().out
    lines = [ln for ln in printed.splitlines() if sweep.TRAIN_MODULE in ln]
    assert len(lines) == 3  # 12 jobs / 4 shards
    assert all(" -m raw2logit_tpu_torch.training.train " in ln
               and ln.endswith("--device cpu") for ln in lines)
    assert [ln.split("]")[0] for ln in lines] == ["[2/12", "[6/12", "[10/12"]
    assert manifest["jobs"] == []


def test_resume_retrains_when_artifacts_vanish(tmp_path, monkeypatch,
                                               capsys):
    """As tests/test_training.py holds JAX's: a job whose state_dict.json
    vanished is retrained and its stale paths leave the manifest."""
    monkeypatch.chdir(tmp_path)
    jobs = sweep.build_grid(["SyntheticMicroscopy"], ["weak"], 1, 4, 1e-5, 1)
    lost, kept = jobs[0], jobs[1]
    run_dir = (tmp_path / "results" / "runs" / "sweep_SyntheticMicroscopy"
               / kept["run_name"] / f"{kept['run_name']}_0")
    run_dir.mkdir(parents=True)
    (run_dir / "state_dict.json").write_text("{}")
    cfg = {"checkpoints": {j["pipeline"]: ["x"] for j in (lost, kept)},
           "state_dicts": {j["pipeline"]: ["y"] for j in (lost, kept)}}
    out = tmp_path / "manifest.json"
    out.write_text(json.dumps({
        "jobs": [dict(j, returncode=0) for j in (lost, kept)],
        "configs": {"SyntheticMicroscopy/weak": cfg}}))
    result = sweep.run_sweep(jobs[:2], dry_run=True, out=str(out),
                             resume=True)
    printed = capsys.readouterr().out
    assert f"will retrain: {lost['run_name']}" in printed
    assert f"skip (done): {kept['run_name']}" in printed
    assert lost["run_name"] in printed.split("skip")[0]
    cfg2 = result["configs"]["SyntheticMicroscopy/weak"]
    assert lost["pipeline"] not in cfg2["checkpoints"]
    assert kept["pipeline"] in cfg2["checkpoints"]


FAKE_TRAIN = """#!{python}
# stands in for `python -m raw2logit_tpu_torch.training.train`: writes the
# fold files a finished job leaves (or fails for one run name)
import json, os, sys
argv = sys.argv[3:]
a = dict(zip(argv[::2], argv[1::2]))
with open("calls.jsonl", "a") as fh:
    fh.write(json.dumps(sys.argv[1:]) + "\\n")
if a["--run_name"].endswith("{fail}"):
    sys.exit(3)
for k in range(int(a["--n_splits"])):
    d = os.path.join("results", "runs", a["--experiment_name"],
                     a["--run_name"], a["--run_name"] + "_" + str(k))
    os.makedirs(os.path.join(d, "checkpoints"), exist_ok=True)
    open(os.path.join(d, "state_dict.json"), "w").write("{{}}")
"""


def test_manifest_is_written_through_and_resumes(tmp_path, monkeypatch):
    """A shard of three jobs through a stand-in for the CLI: the manifest
    after the run holds each job with its return code, the port's
    checkpoint paths per config and the flat view; --resume trains only
    the failed job again."""
    monkeypatch.chdir(tmp_path)
    jobs = sweep.build_grid(["SyntheticMicroscopy"], ["weak"], 1, 4, 1e-5, 2)
    fail = jobs[4]["pipeline"]
    fake = tmp_path / "fake_python"
    fake.write_text(FAKE_TRAIN.format(python=sys.executable, fail=fail))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    out = "m/manifest.json"
    sweep.run_sweep(jobs, shard=0, n_shards=4, out=out, python=str(fake),
                    device="cpu")
    with open(out) as fh:
        manifest = json.load(fh)
    assert [(j["run_name"], j["returncode"]) for j in manifest["jobs"]] == [
        (j["run_name"], 3 if j["pipeline"] == fail else 0)
        for j in jobs[0::4]]
    ok = [j["pipeline"] for j in jobs[0::4] if j["pipeline"] != fail]
    cfg = manifest["configs"]["SyntheticMicroscopy/weak"]
    assert manifest["checkpoints"] == cfg["checkpoints"]
    assert sorted(cfg["checkpoints"]) == sorted(ok)
    first = cfg["checkpoints"][ok[0]]
    assert [os.path.basename(p) for p in first] == ["classifier.pt"] * 2
    assert first[1].endswith(os.path.join(
        f"SyntheticMicroscopy_weak_{ok[0]}_1", "checkpoints",
        "classifier.pt"))
    calls = [json.loads(ln) for ln in open("calls.jsonl")]
    assert all(c[:2] == ["-m", sweep.TRAIN_MODULE] and c[-2:] == [
        "--device", "cpu"] for c in calls)
    sweep.run_sweep(jobs, shard=0, n_shards=4, out=out, python=str(fake),
                    resume=True)
    again = [json.loads(ln) for ln in open("calls.jsonl")][len(calls):]
    assert len(again) == 1 and fail in again[0][again[0].index(
        "--run_name") + 1]


def test_sweep_main_dry_run(capsys):
    sweep.main(["--datasets", "SyntheticMicroscopy", "--dry_run",
                "--epochs", "2", "--lr_schedule", "cosine",
                "--n_shards", "12", "--shard", "11"])
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if sweep.TRAIN_MODULE in ln]
    assert line.startswith("[12/12]") and "--lr_schedule cosine" in line


# --- app --------------------------------------------------------------------

CHOICES = [(db, sh, dn) for db in ("bilinear", "malvar2004", "menon2007")
           for sh in ("sharpening_filter", "unsharp_masking")
           for dn in ("gaussian_denoising", "median_denoising",
                      "fft_denoising")]
# the static ISP's float32 ops in both packages: 2e-6 held for most
# pipelines, but the two packages' float32 pipelines differ by up to 1e-5
# before gamma (tests/test_torch_static.py's STAGE_ATOL: different
# summation orders of the same stencils), and gamma's slope carries that
# through; measured up to 5.3e-6 on this mosaic
APP_TOL = 1e-5


@pytest.fixture(scope="module")
def mosaic():
    """A smooth 48x40 mosaic in [0.05, 0.95] (far from Menon's ties)."""
    y, x = np.mgrid[0:48, 0:40].astype(np.float32)
    m = 0.5 + 0.3 * np.sin(x / 5.0) * np.cos(y / 7.0)
    m += np.random.default_rng(3).uniform(-0.05, 0.05, m.shape)
    return np.clip(m, 0.05, 0.95).astype(np.float32)


@pytest.mark.parametrize("choice", CHOICES, ids=lambda c: "-".join(c))
def test_process_matches_jax(mosaic, choice):
    db, sh, dn = choice
    for camera in (["Microscope", "Drone"] if choice == CHOICES[0]
                   else ["Microscope"]):
        kw = dict(camera=camera, debayer=db, sharpening=sh, denoising=dn)
        got = app.process(mosaic, device="cpu", **kw)
        want = jax_app.process(mosaic, **kw)
        assert got.shape == want.shape == (48, 40, 3)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=APP_TOL)


def test_process_needs_cuda_unless_told_the_cpu(mosaic, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.process(mosaic)


def test_uploads_normalise_8bit_and_rgb(tmp_path):
    """As tests/test_evaluation.py holds JAX's: 8-bit uploads divide by
    255, RGB uploads keep the first channel; the same as JAX's."""
    rng = np.random.default_rng(0)
    for name, shape in (("m8.png", (32, 32)), ("rgb.png", (32, 32, 3))):
        path = str(tmp_path / name)
        Image.fromarray((rng.uniform(0.2, 0.9, shape) * 255).astype(
            np.uint8)).save(path)
        got = app.process_file(path, device="cpu")
        assert got.shape == (32, 32, 3) and float(got.mean()) > 0.05
        np.testing.assert_allclose(got, jax_app.process_file(path),
                                   atol=APP_TOL)
    path16 = str(tmp_path / "m16.png")
    Image.fromarray((rng.uniform(0.2, 0.9, (32, 32)) * 65535).astype(
        np.uint16)).save(path16)
    np.testing.assert_allclose(app.process_file(path16, device="cpu"),
                               jax_app.process_file(path16), atol=APP_TOL)


def _multipart(fields, png):
    boundary = uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
             f'name="{k}"\r\n\r\n'.encode() + v + b"\r\n"
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="file"; filename="m.png"\r\nContent-Type: '
                 f'image/png\r\n\r\n'.encode() + png + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_http_demo_serves_end_to_end(tmp_path):
    """GET / renders the form with every control; POST /process returns
    the PNG of process_file's RGB; a bad upload gets a 400."""
    server = app.make_server(port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        page = urllib.request.urlopen(f"{base}/", timeout=30).read()
        for control in (b"RawImage", b"menon2007", b"unsharp_masking",
                        b"fft_denoising", b"Drone"):
            assert control in page, control
        rng = np.random.default_rng(1)
        buf = io.BytesIO()
        Image.fromarray((rng.uniform(0.2, 0.9, (32, 32)) * 255).astype(
            np.uint8)).save(buf, format="PNG")
        (tmp_path / "m.png").write_bytes(buf.getvalue())
        fields = {"camera": b"Drone", "debayer": b"malvar2004",
                  "sharpening": b"unsharp_masking",
                  "denoising": b"median_denoising"}
        body, ctype = _multipart(fields, buf.getvalue())
        req = urllib.request.Request(f"{base}/process", data=body,
                                     headers={"Content-Type": ctype})
        png = urllib.request.urlopen(req, timeout=60).read()
        want = app.process_file(str(tmp_path / "m.png"), device="cpu",
                                **{k: v.decode() for k, v in fields.items()})
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(png))),
            (np.clip(want, 0, 1) * 255).astype(np.uint8))
        body, ctype = _multipart(fields, b"not an image")
        req = urllib.request.Request(f"{base}/process", data=body,
                                     headers={"Content-Type": ctype})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_cli_writes_the_rgb_png(tmp_path, capsys):
    path = str(tmp_path / "in.png")
    Image.fromarray(np.full((16, 16), 128, np.uint8)).save(path)
    app.main([path, "--device", "cpu"])
    out = str(tmp_path / "in_rgb.png")
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    assert np.asarray(Image.open(out)).shape == (16, 16, 3)
