"""Dataset acquisition: a resumable sync of the public Zenodo record
(port of ``raw2logit_tpu/data/download.py``, stdlib only).

The datasets are published as Zenodo record 5235536 (DOI
10.5281/zenodo.5235536). ``download_record_folder`` reads the record's
manifest from the Zenodo API and streams each file with byte-range resume
and an md5 check. ``b2_download_folder`` and the other ``b2_*`` names
keep the upstream project's call surface, which read a private Backblaze
B2 bucket, and map its folder names onto the record's paths; where the
mirror cannot be reached they raise FileNotFoundError with instructions
for a manual download. The folder datasets call
``download_{drone,microscopy}_dataset`` when their folder is missing.

Tested against a local HTTP server with Range support
(``tests/test_torch_download.py``).
"""

import hashlib
import json
import os
import shutil
import urllib.error
import urllib.request
import zipfile

ZENODO_RECORD = "5235536"
ZENODO_API = f"https://zenodo.org/api/records/{ZENODO_RECORD}"

# the upstream bucket's folder names -> record paths
_B2_TO_RECORD = {
    "drone/images": "drone/images",
    "drone/masks": "drone/masks",
    "Data histopathology/WhiteCellsImages": "microscopy/images",
    "Data histopathology/WhiteCellsLabels": "microscopy/labels",
}

_CHUNK = 1 << 18


def fetch(url, dst, expected_size=None, expected_md5=None, timeout=60):
    """Stream url -> dst with byte-range resume and checksum verification.

    Partial downloads live in ``dst + '.part'``; an interrupted run resumes
    from its size with a Range request. On success the .part is atomically
    renamed to dst."""
    part = dst + ".part"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)

    start = os.path.getsize(part) if os.path.exists(part) else 0
    if expected_size is not None and start >= expected_size:
        # a stale/oversized partial can't be resumed (the Range request
        # would sit at/past EOF -> HTTP 416 forever); start fresh
        os.remove(part)
        start = 0
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    try:
        resp_cm = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        if e.code != 416 or not start:
            raise
        # server rejects the resume point (file changed/shrank) — refetch
        os.remove(part)
        start = 0
        resp_cm = urllib.request.urlopen(urllib.request.Request(url),
                                         timeout=timeout)
    with resp_cm as resp:
        resumed = resp.status == 206
        mode = "ab" if (start and resumed) else "wb"
        with open(part, mode) as fh:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                fh.write(chunk)

    size = os.path.getsize(part)
    if expected_size is not None and size != expected_size:
        raise IOError(f"{dst}: size mismatch ({size} != {expected_size}); "
                      "partial kept for resume")
    if expected_md5 is not None:
        h = hashlib.md5()
        with open(part, "rb") as fh:
            for chunk in iter(lambda: fh.read(_CHUNK), b""):
                h.update(chunk)
        if h.hexdigest() != expected_md5:
            os.remove(part)  # corrupt — a resume could never fix it
            raise IOError(f"{dst}: md5 mismatch "
                          f"({h.hexdigest()} != {expected_md5})")
    os.replace(part, dst)
    return dst


def zenodo_file_list(api_url=ZENODO_API, timeout=60):
    """Record manifest -> [{'name', 'size', 'md5', 'url'}, ...]."""
    with urllib.request.urlopen(api_url, timeout=timeout) as resp:
        record = json.load(resp)
    files = []
    for f in record.get("files", []):
        checksum = f.get("checksum", "")
        md5 = checksum.split(":", 1)[1] if checksum.startswith("md5:") \
            else None
        files.append({"name": f.get("key") or f.get("filename"),
                      "size": f.get("size"),
                      "md5": md5,
                      "url": f["links"]["self"]})
    return files


class _RecordBucket:
    """Read-only stand-in for the upstream B2 bucket handle: the public
    Zenodo record plays the private bucket's role, and this object keeps
    the one bucket method the upstream code uses, ``ls``, yielding objects
    with a ``file_name`` attribute."""

    class _FileInfo:
        def __init__(self, name):
            self.file_name = name

    def __init__(self, api_url=ZENODO_API, timeout=60):
        try:
            self._files = zenodo_file_list(api_url, timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            # same contract as b2_download_folder: instructive error when
            # the mirror is unreachable (a host without network)
            raise FileNotFoundError(
                f"cannot list the dataset record ({e}); the Zenodo mirror "
                f"at {api_url} is unreachable from this host. On a host "
                "with network access, fetch the record manifest manually "
                "or run b2_download_folder there.") from e

    def ls(self, folder="", show_versions=False):
        for f in self._files:
            name = f["name"] or ""
            if name.startswith(folder):
                yield self._FileInfo(name), None


def get_b2_bucket(api_url=ZENODO_API, timeout=60):
    """Reference-surface alias: a listable handle on the dataset store."""
    return _RecordBucket(api_url, timeout=timeout)


def b2_list_files(folder="", api_url=ZENODO_API, timeout=60):
    """Print (and return) the record files under ``folder``."""
    names = []
    for file_info, _ in get_b2_bucket(api_url, timeout=timeout).ls(folder):
        print(file_info.file_name)
        names.append(file_info.file_name)
    return names


_MANIFEST_CACHE = ".zenodo_manifest.json"


def _manifest_complete(local_dir):
    """True when a cached manifest from a previous successful sync lists
    files that are all present at the right size — lets repeat calls
    return without a network round-trip (a blackholed offline host would
    otherwise block on the 60 s manifest timeout every dataset init)."""
    path = os.path.join(local_dir, _MANIFEST_CACHE)
    if not os.path.exists(path):
        return False
    try:
        with open(path) as fh:
            entries = json.load(fh)
    except (OSError, ValueError):
        return False
    for rel, size in entries.items():
        dst = os.path.join(local_dir, rel)
        if not os.path.exists(dst) or (
                size is not None and os.path.getsize(dst) != size):
            return False
    return True


def download_record_folder(folder, local_dir, api_url=ZENODO_API,
                           force_download=False, timeout=60):
    """Sync every record file under ``folder/`` into local_dir; files
    already present (matching size) are skipped. A successful sync
    writes a manifest cache so later calls can skip the network."""
    if not force_download and _manifest_complete(local_dir):
        return local_dir
    files = zenodo_file_list(api_url, timeout=timeout)
    prefix = folder.rstrip("/") + "/"
    os.makedirs(local_dir, exist_ok=True)
    synced = {}
    for f in files:
        if not (f["name"].startswith(prefix) or f["name"] == folder):
            continue
        rel = f["name"][len(prefix):] if f["name"].startswith(prefix) \
            else os.path.basename(f["name"])
        dst = os.path.join(local_dir, rel)
        synced[rel] = f["size"]
        if (not force_download and os.path.exists(dst)
                and (f["size"] is None
                     or os.path.getsize(dst) == f["size"])):
            continue
        print(f"fetching {f['name']} -> {dst}")
        fetch(f["url"], dst, expected_size=f["size"],
              expected_md5=f["md5"])
    if not synced:
        # zero matches means a wrong folder name or a transiently bad
        # file list — caching {} would make _manifest_complete() pass
        # forever and permanently short-circuit future syncs
        raise ValueError(f"record lists no files under '{folder}'")
    with open(os.path.join(local_dir, _MANIFEST_CACHE), "w") as fh:
        json.dump(synced, fh)
    return local_dir


def b2_download_folder(b2_dir, local_dir, force_download=False,
                       mirror_folder=None, api_url=ZENODO_API):
    """The upstream call surface, served from the Zenodo mirror. Raises
    FileNotFoundError with manual instructions when the mirror is
    unreachable."""
    def _complete_content(d):
        # .part leftovers (and the manifest cache itself) are NOT
        # content — treating them as such would skip the sync and strand
        # the resume logic in fetch()
        return os.path.isdir(d) and any(
            not name.endswith(".part") and name != _MANIFEST_CACHE
            for name in os.listdir(d))

    folder = mirror_folder or _B2_TO_RECORD.get(b2_dir, b2_dir)
    try:
        # always consult the manifest: its per-file size check skips
        # complete files cheaply, so an interrupted multi-file sync picks
        # up the missing files instead of short-circuiting on the first
        # complete one. When local content already exists (e.g. synced
        # before the manifest cache existed), probe the network with a
        # short timeout so an offline host falls back to the local copy
        # in seconds, not after the full 60 s stall — every dataset init
        # goes through here.
        timeout = 5 if _complete_content(local_dir) else 60
        return download_record_folder(folder, local_dir, api_url=api_url,
                                      force_download=force_download,
                                      timeout=timeout)
    except (urllib.error.URLError, OSError, ValueError) as e:
        if _complete_content(local_dir) and not force_download:
            # offline but previously synced — serve what's on disk
            print(f"dataset mirror unreachable ({e}); using existing "
                  f"content in {local_dir}")
            return local_dir
        raise FileNotFoundError(
            f"could not sync '{b2_dir}' -> {local_dir}: {e}\n"
            f"This machine cannot reach the dataset mirror. Download the "
            f"record manually from https://zenodo.org/record/"
            f"{ZENODO_RECORD} (DOI 10.5281/zenodo.{ZENODO_RECORD}) on a "
            f"networked host and place the '{folder}' files under "
            f"{local_dir}.") from e


def unzip_all(directory):
    """Extract and remove every .zip directly under directory."""
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".zip"):
            continue
        path = os.path.join(directory, name)
        with zipfile.ZipFile(path) as zf:
            zf.extractall(directory)
        os.remove(path)
    marker = os.path.join(directory, ".bzEmpty")
    if os.path.isfile(marker):
        os.remove(marker)


def download_drone_dataset(data_root="data", force_download=False):
    img_dir = os.path.join(data_root, "drone", "images_full")
    mask_dir = os.path.join(data_root, "drone", "masks_full")
    b2_download_folder("drone/images", img_dir,
                       force_download=force_download)
    b2_download_folder("drone/masks", mask_dir,
                       force_download=force_download)
    unzip_all(img_dir)
    unzip_all(mask_dir)


def download_microscopy_dataset(data_root="data", force_download=False):
    img_dir = os.path.join(data_root, "microscopy", "images")
    label_dir = os.path.join(data_root, "microscopy", "labels")
    b2_download_folder("Data histopathology/WhiteCellsImages", img_dir,
                       force_download=force_download)
    b2_download_folder("Data histopathology/WhiteCellsLabels", label_dir,
                       force_download=force_download)
    unzip_all(img_dir)
    unzip_all(label_dir)
