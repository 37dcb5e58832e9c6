"""The port's dataset download (``raw2logit_tpu_torch/data/download.py``)
on the cases of tests/test_download.py: the resumable fetch and the
Zenodo-manifest sync against a local HTTP server with Range support, and
the raise where the mirror cannot be reached. The mirror's place is taken
by a closed local port throughout: nothing here reaches an outside host.
"""

import hashlib
import http.server
import json
import os
import threading

import pytest

from raw2logit_tpu_torch.data.download import (b2_download_folder,
                                         download_record_folder, fetch,
                                         unzip_all, zenodo_file_list)

PAYLOAD = os.urandom(1 << 16)
OFFLINE = "http://127.0.0.1:9/api"  # a closed port: the unreachable mirror


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    """Serves /data (with Range support) and /api (a Zenodo-style record)."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path in ("/api", "/api2"):
            entry = {
                "key": "folder/blob.bin",
                "links": {"self": f"http://127.0.0.1:{self.server.server_port}/data"},
                "size": len(PAYLOAD),
                "checksum": "md5:" + hashlib.md5(PAYLOAD).hexdigest(),
            }
            files = [entry]
            if self.path == "/api2":  # multi-file record
                files = [entry, dict(entry, key="folder/blob2.bin")]
            record = {"files": files}
            body = json.dumps(record).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        rng = self.headers.get("Range")
        if rng:
            start = int(rng.split("=")[1].split("-")[0])
            body = PAYLOAD[start:]
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{len(PAYLOAD) - 1}/"
                             f"{len(PAYLOAD)}")
        else:
            body = PAYLOAD
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def test_fetch_full_and_checksum(server, tmp_path):
    dst = str(tmp_path / "blob.bin")
    fetch(f"{server}/data", dst, expected_size=len(PAYLOAD),
          expected_md5=hashlib.md5(PAYLOAD).hexdigest())
    with open(dst, "rb") as fh:
        assert fh.read() == PAYLOAD
    assert not os.path.exists(dst + ".part")


def test_fetch_resumes_partial(server, tmp_path):
    dst = str(tmp_path / "blob.bin")
    # simulate an interrupted download: half the payload in .part
    with open(dst + ".part", "wb") as fh:
        fh.write(PAYLOAD[: len(PAYLOAD) // 2])
    fetch(f"{server}/data", dst, expected_size=len(PAYLOAD),
          expected_md5=hashlib.md5(PAYLOAD).hexdigest())
    with open(dst, "rb") as fh:
        assert fh.read() == PAYLOAD


def test_fetch_rejects_bad_checksum(server, tmp_path):
    with pytest.raises(IOError, match="md5"):
        fetch(f"{server}/data", str(tmp_path / "x.bin"),
              expected_md5="0" * 32)


def test_zenodo_manifest_and_folder_sync(server, tmp_path):
    files = zenodo_file_list(f"{server}/api")
    assert files[0]["name"] == "folder/blob.bin"
    assert files[0]["size"] == len(PAYLOAD)

    local = str(tmp_path / "folder")
    out = download_record_folder("folder", local, api_url=f"{server}/api")
    with open(os.path.join(out, "blob.bin"), "rb") as fh:
        assert fh.read() == PAYLOAD
    # second call is a no-op (already present)
    download_record_folder("folder", local, api_url=f"{server}/api")


def test_b2_download_folder_offline_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="zenodo"):
        b2_download_folder("drone/images", str(tmp_path / "nope"),
                           api_url=OFFLINE)


def test_b2_list_files_offline_raises_with_instructions():
    from raw2logit_tpu_torch.data.download import b2_list_files
    with pytest.raises(FileNotFoundError, match="unreachable"):
        b2_list_files("folder", api_url=OFFLINE)


def test_b2_list_files_and_bucket_ls(server, capsys):
    """The upstream surface: get_b2_bucket().ls() yields (file_info, _)
    with .file_name; b2_list_files prints names."""
    from raw2logit_tpu_torch.data.download import b2_list_files, get_b2_bucket

    names = b2_list_files("folder", api_url=f"{server}/api2")
    assert names == ["folder/blob.bin", "folder/blob2.bin"]
    assert "folder/blob.bin" in capsys.readouterr().out

    bucket = get_b2_bucket(api_url=f"{server}/api2")
    assert [fi.file_name for fi, _ in bucket.ls("folder/blob2")] == \
        ["folder/blob2.bin"]
    assert list(bucket.ls("elsewhere")) == []


def test_unzip_all(tmp_path):
    import zipfile
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as zf:
        zf.writestr("inner.txt", "hello")
    unzip_all(str(tmp_path))
    assert (tmp_path / "inner.txt").read_text() == "hello"
    assert not (tmp_path / "a.zip").exists()


def test_fetch_discards_oversized_partial(server, tmp_path):
    """A .part at/past the expected size cannot be resumed (Range at EOF
    -> HTTP 416 forever); fetch must restart it."""
    dst = str(tmp_path / "blob.bin")
    with open(dst + ".part", "wb") as fh:
        fh.write(b"\0" * (len(PAYLOAD) + 10))
    fetch(f"{server}/data", dst, expected_size=len(PAYLOAD),
          expected_md5=hashlib.md5(PAYLOAD).hexdigest())
    with open(dst, "rb") as fh:
        assert fh.read() == PAYLOAD


def test_b2_resumes_interrupted_multifile_sync(server, tmp_path):
    """One complete file must NOT short-circuit the sync: the manifest is
    always consulted so missing files of a multi-file record are fetched
    (an early return on any non-.part file would strand them)."""
    local = str(tmp_path / "folder")
    os.makedirs(local)
    with open(os.path.join(local, "blob.bin"), "wb") as fh:
        fh.write(PAYLOAD)  # first file fully synced, second missing
    out = b2_download_folder("folder", local, api_url=f"{server}/api2",
                             mirror_folder="folder")
    with open(os.path.join(out, "blob2.bin"), "rb") as fh:
        assert fh.read() == PAYLOAD


def test_b2_offline_serves_existing_content(tmp_path):
    """Mirror unreachable but content previously synced -> serve local."""
    local = str(tmp_path / "folder")
    os.makedirs(local)
    with open(os.path.join(local, "blob.bin"), "wb") as fh:
        fh.write(PAYLOAD)
    out = b2_download_folder(
        "folder", local, api_url=OFFLINE,
        mirror_folder="folder")
    assert out == local


def test_b2_skip_ignores_part_leftovers(server, tmp_path):
    """A directory holding only .part leftovers is NOT synced content;
    the skip must not strand the resume."""
    local = str(tmp_path / "folder")
    os.makedirs(local)
    with open(os.path.join(local, "blob.bin.part"), "wb") as fh:
        fh.write(PAYLOAD[:100])
    out = b2_download_folder("folder", local, api_url=f"{server}/api",
                             mirror_folder="folder")
    with open(os.path.join(out, "blob.bin"), "rb") as fh:
        assert fh.read() == PAYLOAD


def test_manifest_cache_skips_network_when_complete(server, tmp_path):
    """A successful sync writes a manifest cache; later calls with all
    files intact return WITHOUT touching the network (offline hosts with
    blackholed egress would otherwise block on the manifest timeout)."""
    local = str(tmp_path / "folder")
    b2_download_folder("folder", local, api_url=f"{server}/api",
                       mirror_folder="folder")
    # unreachable API now — must still succeed instantly from the cache
    out = b2_download_folder("folder", local,
                             api_url="http://127.0.0.1:9/api",
                             mirror_folder="folder")
    with open(os.path.join(out, "blob.bin"), "rb") as fh:
        assert fh.read() == PAYLOAD


def test_manifest_cache_detects_missing_file(server, tmp_path):
    """Deleting a synced file invalidates the cache: the next call
    consults the live manifest and re-fetches."""
    local = str(tmp_path / "folder")
    b2_download_folder("folder", local, api_url=f"{server}/api",
                       mirror_folder="folder")
    os.remove(os.path.join(local, "blob.bin"))
    b2_download_folder("folder", local, api_url=f"{server}/api",
                       mirror_folder="folder")
    with open(os.path.join(local, "blob.bin"), "rb") as fh:
        assert fh.read() == PAYLOAD


def test_empty_folder_sync_never_caches_a_manifest(server, tmp_path):
    """A folder name matching zero record files must raise (not cache an
    empty manifest that would short-circuit every future sync)."""
    from raw2logit_tpu_torch.data.download import (_MANIFEST_CACHE,
                                             download_record_folder)
    local = str(tmp_path / "typo")
    with pytest.raises(ValueError, match="no files"):
        download_record_folder("no-such-folder", local,
                               api_url=f"{server}/api")
    assert not os.path.exists(os.path.join(local, _MANIFEST_CACHE))
    # and the next call consults the network again rather than serving
    # the (nonexistent) cache
    with pytest.raises(ValueError, match="no files"):
        download_record_folder("no-such-folder", local,
                               api_url=f"{server}/api")


def test_manifest_parsed_as_jax(server):
    from raw2logit_tpu.data.download import zenodo_file_list as jax_list
    for api in ("/api", "/api2"):
        assert zenodo_file_list(server + api) == jax_list(server + api)


def test_download_drone_and_microscopy_layouts(tmp_path, monkeypatch):
    """The two dataset downloads sync the record's folders into the
    layout the dataset classes read, then unzip them."""
    from raw2logit_tpu_torch.data import download
    calls = []
    monkeypatch.setattr(download, "b2_download_folder",
                        lambda b2_dir, local, force_download=False:
                        calls.append((b2_dir, local)) or os.makedirs(local))
    download.download_drone_dataset(data_root=str(tmp_path))
    download.download_microscopy_dataset(data_root=str(tmp_path))
    assert calls == [
        ("drone/images", str(tmp_path / "drone" / "images_full")),
        ("drone/masks", str(tmp_path / "drone" / "masks_full")),
        ("Data histopathology/WhiteCellsImages",
         str(tmp_path / "microscopy" / "images")),
        ("Data histopathology/WhiteCellsLabels",
         str(tmp_path / "microscopy" / "labels"))]
