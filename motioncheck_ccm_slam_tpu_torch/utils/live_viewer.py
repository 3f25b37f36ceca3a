"""Live map viewer: the RViz replacement (reference src/Viewer.cpp
RunClient/RunServer publish KF trajectories, covis/loop edges, and the
landmark cloud to RViz at Vis.*  rates).

A copy of ``motioncheck_ccm_slam_tpu/utils/live_viewer.py`` over the
port's ``viewer.map_payload``. A tiny in-process HTTP server serves the
same pure-canvas orbit renderer as ``viewer.export_html``, but the page
polls ``/state.json`` (~2 Hz) so the map animates while the system runs.
Zero dependencies; the payload is produced by ``viewer.map_payload`` under
the caller's control (call ``update()`` wherever the reference called
DrawMap)."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

from . import viewer as viewer_mod

_LIVE_TEMPLATE = viewer_mod._HTML_TEMPLATE.replace(
    "const DATA = %DATA%;",
    """let DATA = %DATA%;
async function poll(){
 try{const r = await fetch('/state.json');
  if(r.ok){const d = await r.json();
   if(d.seq !== DATA.seq){DATA = d; draw();}}}
 catch(e){}
 setTimeout(poll, 500);}
poll();""",
)

_EMPTY = {"points": [], "trajs": [], "edges": [],
          "center": [0.0, 0.0, 0.0], "radius": 1.0, "seq": 0}


class LiveViewer:
    """Background HTTP server streaming the current map state.

    >>> lv = LiveViewer()          # port 0 = auto; lv.url to browse
    >>> lv.update({"server": map_state})
    >>> lv.close()
    """

    def __init__(self, port: int = 0, title: str = "live map"):
        self._payload = json.dumps(_EMPTY).encode()
        self._seq = 0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.startswith("/state.json"):
                    body = outer._get_payload()
                    ctype = "application/json"
                else:
                    with outer._lock:
                        data = outer._payload.decode()
                    body = (_LIVE_TEMPLATE
                            .replace("%TITLE%", title)
                            .replace("%DATA%", data)).encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # silence request logging
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}/"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def _get_payload(self) -> bytes:
        with self._lock:
            return self._payload

    def update(self, maps: Dict[str, object]):
        """Publish the current state of one or more MapStates (the viewer
        merges them — distinct maps keep their per-client trajectory
        colors)."""
        merged = dict(_EMPTY)
        merged["points"], merged["trajs"], merged["edges"] = [], [], []
        allp = []
        for name, m in maps.items():
            p = viewer_mod.map_payload(m)
            merged["points"].extend(p["points"])
            merged["trajs"].extend(p["trajs"])
            merged["edges"].extend(p["edges"])
            if p["points"] or p["trajs"]:
                allp.append((np.asarray(p["center"]), p["radius"]))
        if allp:
            centers = np.stack([c for c, _ in allp])
            merged["center"] = centers.mean(0).round(4).tolist()
            merged["radius"] = float(max(r for _, r in allp))
        self._seq += 1
        merged["seq"] = self._seq
        body = json.dumps(merged).encode()
        with self._lock:
            self._payload = body

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=2)
