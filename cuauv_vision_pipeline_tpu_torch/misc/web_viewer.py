#!/usr/bin/env python3
"""Minimal web GUI: live module posts as MJPEG streams + tuner sliders.

The reference's WebGUI is an external repo consuming ModuleReader
(SURVEY.md §1 L10); this built-in viewer closes the loop with zero extra
dependencies: a stdlib http.server serving

* ``/``                     — an index page listing active modules, their
                              post streams, live tuner controls, module
                              toggles (incl. record start/stop), and live
                              shm result groups;
* ``/stream/<module>/<post>`` — multipart MJPEG of that post block;
* ``/tuner/<module>?name=&value=`` — POST target wired to
                              ModuleReader.update_tuner_value;
* ``/toggle/<module>/<source>?on=`` — POST flips the module toggler's shm
                              flag (record/replay and any vehicle-config
                              module start/stop from the browser);
* ``/shm/<group>``          — JSON snapshot of a result group (the index
                              polls these for a live detection readout).

Plain HTTP polling, not websockets: the streams are MJPEG anyway, tuner
writes are sub-ms, and stdlib-only keeps the vehicle image dependency-free.

Port of ``cuauv_vision_pipeline_tpu.misc.web_viewer`` on the port's
ModuleReader, ``encode_jpeg`` and ModuleToggler; the results readout lists
the groups of this process's ``CUAUV_SHM_NAMESPACE``.

    python -m cuauv_vision_pipeline_tpu_torch.misc.web_viewer [--port 8080]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from ..core.base import ModuleReader
from ..capture_sources.stream_server import encode_jpeg

_readers = {}
_lock = threading.Lock()
_latest = {}  # (module, post) -> jpeg bytes


def _reader_for(module: str) -> ModuleReader:
    with _lock:
        reader = _readers.get(module)
        if reader is not None and reader.framework_deleted:
            # the reader itself rediscovers new post/tune blocks; only a
            # torn-down module framework needs a rebuild
            reader.unblock()
            _readers.pop(module, None)
            reader = None
        if reader is None:
            reader = ModuleReader(module)

            def on_post(mod, name, idx, img, cs, _m=module):
                bgr = img if img.ndim == 3 else np.repeat(img[..., None] if img.ndim == 2 else img, 3, -1)
                if bgr.ndim == 3 and bgr.shape[-1] == 1:
                    bgr = np.repeat(bgr, 3, -1)
                _latest[(_m, name)] = encode_jpeg(
                    np.ascontiguousarray(bgr), quality=80
                )

            reader.register_post_udl(on_post)
            reader.run_forever(fps=30)
            _readers[module] = reader
        return reader


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        url = urlparse(self.path)
        parts = [unquote(p) for p in url.path.strip("/").split("/") if p]
        if not parts:
            return self._index()
        if parts[0] == "stream" and len(parts) == 3:
            return self._stream(parts[1], parts[2])
        if parts[0] == "modules":
            return self._json(ModuleReader.get_active_modules())
        if parts[0] == "shm" and len(parts) == 2:
            from ..core import shm

            try:
                return self._json(vars(shm.group(parts[1]).get()))
            except KeyError:
                return self.send_error(404)
        self.send_error(404)

    def do_POST(self):
        url = urlparse(self.path)
        parts = [unquote(p) for p in url.path.strip("/").split("/") if p]
        if parts and parts[0] == "tuner" and len(parts) == 2:
            q = parse_qs(url.query)
            name = q.get("name", [""])[0]
            value = q.get("value", [""])[0]
            reader = _reader_for(parts[1])
            reader.update_tuner_value(name, reader.tuner_cast(name, value))
            return self._json({"ok": True})
        if parts and parts[0] == "toggle" and len(parts) == 3:
            # flip the module toggler's shm flag: a running toggler daemon
            # starts/stops the subprocess (record = in-browser record button)
            from ..core import shm
            from ..core.module_toggler import ModuleToggler

            q = parse_qs(url.query)
            on = q.get("on", ["true"])[0].lower() in ("1", "true", "on")
            flag = ModuleToggler._flag_name(parts[1], parts[2])
            if flag not in shm.vision_modules.field_names():
                return self.send_error(404)
            shm.vision_modules.set_field(flag, on)
            return self._json({"ok": True, "flag": flag, "on": on})
        self.send_error(404)

    def _json(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _index(self):
        rows = []
        for module in sorted(ModuleReader.get_active_modules()):
            reader = _reader_for(module)
            posts = sorted(reader.known_posts)
            tuners = dict(sorted(reader.tuner_values().items()))
            streams = "".join(
                f'<figure><img src="/stream/{module}/{p}" width=480>'
                f"<figcaption>{p}</figcaption></figure>"
                for p in posts
            )
            sliders = "".join(
                f'<label>{n}: <input type="number" value="{v}" '
                f"onchange=\"fetch('/tuner/{module}?name={n}&value='+this.value,"
                f"{{method:'POST'}})\"></label><br>"
                for n, v in tuners.items()
            )
            rows.append(
                f"<h2>{module}</h2><div style='display:flex;flex-wrap:wrap'>"
                f"{streams}</div><h3>tuners</h3>{sliders}"
            )

        # module toggles (the toggler daemon acts on these flags): record
        # start/stop from the browser is the record-button story
        toggles = []
        try:
            from ..core import shm

            flags = shm.vision_modules
            for flag in sorted(flags.field_names()):
                mod_src = flag.rsplit("_on_", 1)
                if len(mod_src) != 2:
                    continue
                m, s = mod_src
                on = bool(flags.get_field(flag))
                toggles.append(
                    f'<label><input type="checkbox" {"checked" if on else ""} '
                    f"onchange=\"fetch('/toggle/{m}/{s}?on='+this.checked,"
                    f"{{method:'POST'}})\"> {m} on {s}</label><br>"
                )
        except Exception:
            pass
        toggle_html = (
            "<h2>modules (toggler)</h2>" + "".join(toggles) if toggles else ""
        )

        # live result groups readout (poll /shm/<group> every 500 ms)
        groups = []
        try:
            from ..core import shm as _shm

            for name in _shm.list_groups():
                # every group a detection/handler path writes: *_results,
                # the yolo handler groups (yolo_gate, yolo_status, ...),
                # and the bins pose output
                if (
                    "results" in name
                    or name.startswith("yolo_")
                    or name in ("bins_pose", "poster_status")
                ):
                    groups.append(name)
        except OSError:
            pass
        results_html = "".join(
            f'<h3>{g}</h3><pre id="shm_{g}">...</pre>' for g in groups
        )
        poll_js = (
            "<script>setInterval(function(){"
            + "".join(
                f"fetch('/shm/{g}').then(r=>r.json()).then(d=>"
                f"document.getElementById('shm_{g}').textContent="
                "JSON.stringify(d,null,1));"
                for g in groups
            )
            + "},500);</script>"
        )
        body = (
            "<html><head><title>vision</title></head><body>"
            "<h1>tpu-vision-pipeline (PyTorch/CUDA port)</h1>"
            + "".join(rows)
            + toggle_html
            + ("<h2>results</h2>" + results_html + poll_js if groups else "")
            + "</body></html>"
        ).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _stream(self, module: str, post: str):
        _reader_for(module)
        self.send_response(200)
        self.send_header(
            "Content-Type", "multipart/x-mixed-replace; boundary=frame"
        )
        self.end_headers()
        try:
            while True:
                jpeg = _latest.get((module, post))
                if jpeg is not None:
                    self.wfile.write(b"--frame\r\n")
                    self.wfile.write(b"Content-Type: image/jpeg\r\n")
                    self.wfile.write(
                        f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                    )
                    self.wfile.write(jpeg)
                    self.wfile.write(b"\r\n")
                time.sleep(1 / 30)
        except (BrokenPipeError, ConnectionResetError):
            pass


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="live module post viewer")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"web viewer on http://0.0.0.0:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
