"""Web demo of the static raw -> RGB pipeline (port of the repository's
``app.py``):

    python -m raw2logit_tpu_torch.app input.png [--device cpu]
    python -m raw2logit_tpu_torch.app --serve [port] [--device cpu]

Upload a raw mosaic (tiff or png), pick the camera parameters and the
debayer, sharpening and denoising, get the processed RGB. Three ways,
as in the JAX package: ``launch()`` (the gradio UI where gradio is
importable, else the HTTP UI), ``serve_http()`` (a stdlib http.server
with the same controls: GET / renders the form, POST /process returns
the PNG) and ``process_file`` / the command line (writes
``<input>_rgb.png``). ``process`` runs the port's ``StaticPipeline`` on
the device given, ``cuda`` unless told the CPU (it raises without CUDA).
PIL is imported only where a file is read or a PNG written.
"""

import argparse

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.data.datasets import (DRONE_CAMERA_PARAMS,
                                               MICROSCOPY_CAMERA_PARAMS)
from raw2logit_tpu_torch.isp import StaticPipeline

CAMERAS = {"Microscope": MICROSCOPY_CAMERA_PARAMS,
           "Drone": DRONE_CAMERA_PARAMS}


def process(raw, camera="Microscope", debayer="bilinear",
            sharpening="sharpening_filter", denoising="gaussian_denoising",
            device=None):
    """raw (H, W) float in [0, 1] -> RGB (H, W, 3) float32 numpy in [0, 1],
    computed on ``device`` (None: cuda)."""
    pipe = StaticPipeline(camera_parameters=CAMERAS[camera],
                          debayer=debayer, sharpening=sharpening,
                          denoising=denoising)
    raw = torch.as_tensor(np.asarray(raw, np.float32),
                          device=resolve_device(device))
    return pipe(raw).permute(1, 2, 0).cpu().numpy()


def process_file(path, device=None, **kw):
    """``process`` of an image file: an RGB(A) upload's first channel is
    the mosaic (as in the reference app), normalised by its bit depth."""
    from PIL import Image
    img = np.asarray(Image.open(path))
    if img.ndim == 3:
        img = img[:, :, 0]
    # normalise by the actual bit depth (an 8-bit upload divided by
    # 2^16 - 1 would render near-black)
    if img.dtype == np.uint8:
        raw = img.astype(np.float32) / 255.0
    elif img.dtype.kind in "ui":
        raw = img.astype(np.float32) / (2 ** 16 - 1)
    else:
        raw = img.astype(np.float32)
        if raw.max() > 1:
            raw = raw / (2 ** 16 - 1)
    return process(raw, device=device, **kw)


def to_png(rgb, path_or_buffer):
    """Write an (H, W, 3) image in [0, 1] as an 8-bit PNG."""
    from PIL import Image
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
        path_or_buffer, format="PNG")


_FORM_HTML = """<!doctype html>
<title>raw2logit static ISP demo</title>
<h1>raw2logit static ISP demo</h1>
<form action="/process" method="post" enctype="multipart/form-data">
  <p>RawImage: <input type="file" name="file" required></p>
  <p>CameraParameters:
    <select name="camera">{cameras}</select></p>
  <p>Debayer:
    <select name="debayer"><option>bilinear</option>
      <option>malvar2004</option><option>menon2007</option></select></p>
  <p>Sharpening:
    <select name="sharpening"><option>sharpening_filter</option>
      <option>unsharp_masking</option></select></p>
  <p>Denoising:
    <select name="denoising"><option>gaussian_denoising</option>
      <option>median_denoising</option><option>fft_denoising</option>
    </select></p>
  <p><input type="submit" value="Process"></p>
</form>"""


def _parse_multipart(content_type, body):
    """{field: bytes-or-str} from a multipart/form-data body (the stdlib
    email parser; the cgi module is deprecated)."""
    import email.parser
    import email.policy
    head = (f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n"
            ).encode()
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        head + body)
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        if part.get_filename() is None:
            payload = payload.decode("utf-8", "replace").strip()
        fields[name] = payload
    return fields


def make_server(host="127.0.0.1", port=7860, device=None):
    """A dependency-free HTTP server with the demo interface: GET / renders
    the form; POST /process runs the static pipeline on ``device`` and
    returns the RGB as a PNG (a failed request gets a 400 with the
    error)."""
    import http.server
    import io
    import tempfile

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, payload):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            cams = "".join(f"<option>{c}</option>" for c in CAMERAS)
            self._send(200, "text/html; charset=utf-8",
                       _FORM_HTML.format(cameras=cams).encode())

        def do_POST(self):
            if self.path != "/process":
                self._send(404, "text/plain", b"not found")
                return
            try:
                length = self.headers["Content-Length"]
                if length is None:
                    self._send(411, "text/plain", b"length required")
                    return
                # Content-Length is the client's: reading an arbitrarily
                # large body into memory is a one-request OOM
                if int(length) > 64 * 1024 * 1024:
                    self._send(413, "text/plain", b"payload too large")
                    return
                body = self.rfile.read(int(length))
                fields = _parse_multipart(self.headers["Content-Type"],
                                          body)
                with tempfile.NamedTemporaryFile(suffix=".png") as fh:
                    fh.write(fields["file"])
                    fh.flush()
                    rgb = process_file(
                        fh.name, device=device,
                        camera=fields.get("camera", "Microscope"),
                        debayer=fields.get("debayer", "bilinear"),
                        sharpening=fields.get("sharpening",
                                              "sharpening_filter"),
                        denoising=fields.get("denoising",
                                             "gaussian_denoising"))
                buf = io.BytesIO()
                to_png(rgb, buf)
                self._send(200, "image/png", buf.getvalue())
            except Exception as e:  # noqa: BLE001 -- reported to the client
                self._send(400, "text/plain", f"error: {e}".encode())

    return http.server.ThreadingHTTPServer((host, port), Handler)


def serve_http(host="127.0.0.1", port=7860, device=None):
    server = make_server(host, port, device=device)
    print(f"serving the ISP demo at http://{host}:{server.server_port}/")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def launch(device=None):
    """The gradio UI where gradio is importable, else ``serve_http``."""
    try:
        import gradio as gr
    except ImportError:
        print("gradio not installed; serving the stdlib HTTP demo instead "
              "(process_file(path) also works offline)")
        serve_http(device=device)
        return None
    demo = gr.Interface(
        # gradio 3.x hands a tempfile-like object, 4.x a filepath str
        fn=lambda f, cam, db, sh, dn: process_file(
            f if isinstance(f, str) else f.name, device=device, camera=cam,
            debayer=db, sharpening=sh, denoising=dn),
        inputs=[gr.File(label="RawImage"),
                gr.Dropdown(list(CAMERAS), value="Microscope",
                            label="CameraParameters"),
                gr.Dropdown(["bilinear", "malvar2004", "menon2007"],
                            value="bilinear", label="Debayer"),
                gr.Dropdown(["sharpening_filter", "unsharp_masking"],
                            value="sharpening_filter", label="Sharpening"),
                gr.Dropdown(["gaussian_denoising", "median_denoising",
                             "fft_denoising"], value="gaussian_denoising",
                            label="Denoising")],
        outputs=gr.Image(label="Processed RGB"),
        title="raw2logit static ISP demo")
    demo.launch()
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description="static ISP demo")
    p.add_argument("input", nargs="?", help="a raw mosaic image file")
    p.add_argument("--serve", nargs="?", type=int, const=7860, default=None,
                   metavar="PORT", help="serve the HTTP demo")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    if args.serve is not None:
        serve_http(port=args.serve, device=args.device)
    elif args.input:
        rgb = process_file(args.input, device=args.device)
        out = args.input.rsplit(".", 1)[0] + "_rgb.png"
        to_png(rgb, out)
        print(f"wrote {out}")
    else:
        launch(device=args.device)


if __name__ == "__main__":
    main()
