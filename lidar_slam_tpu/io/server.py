"""Streaming scan server + client — the reference's edge/HTTP data plane.

Capability parity with the 3-process chain ``Lidar_server.py`` (pandas CSV ->
chunked JSON rows, magic param=9000 -> map PNG) / ``ESP32_Server.c`` (HTTP
relay) / ``esp32_edge.c`` (libcurl + cJSON client) — SURVEY §3.4. Protocol
kept compatible: ``GET /?param=N`` returns scan row N as a JSON float array;
``param=9000`` returns the rendered map PNG; ``pose_x``/``pose_y`` query keys
are accepted (and logged) like the ESP32 firmware does.

On the device side the client is a prefetching iterator feeding the
host->device pipeline (the "edge offload" split maps to host CPU <-> GPU:
cheap ingest on the host, heavy math on the device).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Queue
from urllib.parse import parse_qs, urlparse

import numpy as np

MAP_PARAM = 9000  # magic row id returning the rendered map (Lidar_server.py:34)


class ScanServer:
    """Serves dataset rows over HTTP. Runs in a background thread."""

    def __init__(self, ranges: np.ndarray, host: str = "127.0.0.1",
                 port: int = 0, map_png: str | None = None):
        ranges = np.asarray(ranges, np.float32)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                q = parse_qs(urlparse(self.path).query)
                try:
                    param = int(q.get("param", ["-1"])[0])
                except ValueError:
                    param = -1
                outer.last_pose = (q.get("pose_x", [None])[0],
                                   q.get("pose_y", [None])[0])
                if param == MAP_PARAM and map_png:
                    with open(map_png, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if 0 <= param < len(ranges):
                    body = json.dumps(
                        [round(float(v), 2) for v in ranges[param]]).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self.last_pose: tuple = (None, None)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "ScanServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class RelayServer:
    """HTTP relay: forwards each request to an upstream ``ScanServer`` and
    streams the body back — the ESP32's role in the reference's 3-process
    chain (edge PC <-> ESP32 <-> dataset server; ``ESP32_Server.c:35-96``:
    parse ``param``/``pose_x``/``pose_y``, log the pose, proxy the query
    upstream, relay the JSON/PNG body). Runs in a background thread."""

    def __init__(self, upstream_url: str, host: str = "127.0.0.1",
                 port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                q = parse_qs(urlparse(self.path).query)
                # the firmware logs pose/param on the device console
                # (ESP32_Server.c:43-54); we keep the last pose observable
                outer.last_pose = (q.get("pose_x", [None])[0],
                                   q.get("pose_y", [None])[0])
                outer.n_relayed += 1
                try:
                    with urllib.request.urlopen(
                            upstream_url + "/?" + urlparse(self.path).query,
                            timeout=10.0) as resp:
                        body = resp.read()
                        ctype = resp.headers.get("Content-Type",
                                                 "application/json")
                except Exception:
                    # upstream connect failure -> 404 relay
                    # (ESP32_Server.c:68-71)
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self.last_pose: tuple = (None, None)
        self.n_relayed = 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "RelayServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def fetch_scan(url: str, param: int, pose=None, timeout: float = 5.0) -> np.ndarray:
    """Client side of the protocol (the esp32_edge.c:52-99 role)."""
    q = f"{url}/?param={param}"
    if pose is not None:
        q += f"&pose_x={pose[0]:.3f}&pose_y={pose[1]:.3f}"
    with urllib.request.urlopen(q, timeout=timeout) as resp:
        return np.asarray(json.loads(resp.read()), np.float32)


def scan_stream(url: str, n_scans: int, prefetch: int = 8):
    """Prefetching iterator over served scans (host input pipeline)."""
    q: Queue = Queue(maxsize=prefetch)

    def worker():
        for t in range(n_scans):
            q.put(fetch_scan(url, t))
        q.put(None)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item


def run_streaming_slam(url: str, n_scans: int, cfg) -> "tuple":
    """End-to-end streaming run: HTTP scans -> jitted SLAM steps.

    The streaming analog of the reference's edge pipeline (esp32_edge.c main
    loop): scan t is fetched over HTTP while scan t-1 computes."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models import scan_matcher

    stream = scan_stream(url, n_scans)
    step = scan_matcher.make_step_fn(cfg)
    state = scan_matcher.init_state(jnp.asarray(next(stream)), cfg)
    poses = [np.zeros(3, np.float32)]
    for ranges in stream:
        state, pose = step(state, jnp.asarray(ranges))
        poses.append(np.asarray(pose))
    return np.stack(poses), state
