"""Viewer-lite: map / trajectory rendering to image files.

Counterpart of ``motioncheck_ccm_slam_tpu/utils/viewer.py``, which replaces
the reference's RViz marker publisher (src/Viewer.cpp — KF frusta,
per-client colored trajectories, covisibility edges, landmark cloud) with
matplotlib exports, with the same per-client color table (reference
conf/config.yaml:133-176 color blocks). The card's machine has no
matplotlib, so ``render_map`` and ``render_trajectories`` rasterise the
same top-down x-z views with numpy and write them with ``utils/png.py``
(the same layers and colours; not matplotlib's pixels, and no text).
``map_payload`` and ``export_html`` are copies: pure numpy and JSON.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import png

CLIENT_COLORS = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd"]  # 4 agents

# figure of 9 x 6 in at 120 dpi, as the JAX package's matplotlib exports
WIDTH, HEIGHT, MARGIN = 1080, 720, 40
LANDMARK_RGB = (153, 153, 153)
COVIS_RGB = (204, 204, 204)


def _rgb(color: str) -> tuple:
    return tuple(int(color[k:k + 2], 16) for k in (1, 3, 5))


class _Canvas:
    """A white RGB raster with an equal-aspect map from world (x, z) to
    pixels over the given extent (the view of ``set_aspect("equal")``)."""

    def __init__(self, xz: np.ndarray):
        self.img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
        lo = xz.min(0) if len(xz) else np.zeros(2)
        hi = xz.max(0) if len(xz) else np.ones(2)
        span = np.maximum(hi - lo, 1e-6)
        self.scale = min((WIDTH - 2 * MARGIN) / span[0], (HEIGHT - 2 * MARGIN) / span[1])
        self.center = (lo + hi) / 2
        self.img[MARGIN - 1, MARGIN - 1:WIDTH - MARGIN + 1] = 0     # the axes' frame
        self.img[HEIGHT - MARGIN, MARGIN - 1:WIDTH - MARGIN + 1] = 0
        self.img[MARGIN - 1:HEIGHT - MARGIN + 1, MARGIN - 1] = 0
        self.img[MARGIN - 1:HEIGHT - MARGIN + 1, WIDTH - MARGIN] = 0

    def pixels(self, xz: np.ndarray) -> np.ndarray:
        """(N, 2) world x, z -> (N, 2) int pixel column, row (z up)."""
        u = WIDTH / 2 + (xz[:, 0] - self.center[0]) * self.scale
        v = HEIGHT / 2 - (xz[:, 1] - self.center[1]) * self.scale
        return np.round(np.stack([u, v], -1)).astype(np.int64)

    def dots(self, xz: np.ndarray, rgb, radius: int = 0) -> None:
        if not len(xz):
            return
        uv = self.pixels(xz)
        for du in range(-radius, radius + 1):
            for dv in range(-radius, radius + 1):
                u, v = uv[:, 0] + du, uv[:, 1] + dv
                ok = (u >= 0) & (u < WIDTH) & (v >= 0) & (v < HEIGHT)
                self.img[v[ok], u[ok]] = rgb

    def polyline(self, xz: np.ndarray, rgb) -> None:
        """Segments between consecutive points, sampled a pixel apart."""
        uv = self.pixels(xz).astype(np.float64)
        for p, q in zip(uv[:-1], uv[1:]):
            n = int(np.abs(q - p).max()) + 1
            s = np.linspace(0.0, 1.0, n + 1)[:, None]
            pts = p + s * (q - p)
            u, v = np.round(pts[:, 0]).astype(np.int64), np.round(pts[:, 1]).astype(np.int64)
            ok = (u >= 0) & (u < WIDTH) & (v >= 0) & (v < HEIGHT)
            self.img[v[ok], u[ok]] = rgb

    def save(self, path: str) -> None:
        png.write_png(path, self.img)


def _centres(Tcw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) world->camera poses -> (N, 3) camera centres."""
    return np.linalg.inv(Tcw)[:, :3, 3]


def render_map(m, path: str, title: str = "map",
               show_covis: bool = False) -> None:
    """Top-down (x-z) render of a MapState: landmarks (grey) + each client's
    keyframe centres in ``CLIENT_COLORS`` order, joined in time order, and
    with ``show_covis`` the covisibility edges of weight >= 15. ``title``
    is kept for the JAX package's signature; the raster carries no text."""
    from ..models import map_state as ms

    mp_valid = m.mp.valid.cpu().numpy()
    X = m.mp.Xw.cpu().numpy()[mp_valid]
    kf_valid = m.kf.valid.cpu().numpy()
    cids = m.kf.client_id.cpu().numpy()
    ts = m.kf.timestamp.cpu().numpy()
    Tall = m.kf.Tcw.cpu().numpy()
    centres = np.zeros((len(Tall), 3))
    centres[kf_valid] = _centres(Tall[kf_valid])
    canvas = _Canvas(np.concatenate([X[:, [0, 2]], centres[kf_valid][:, [0, 2]]]))
    if show_covis:
        W = ms.covisibility(m.kf, m.nm).cpu().numpy()
        for a, b in np.argwhere(np.triu(W, 1) >= 15):
            if kf_valid[a] and kf_valid[b]:
                canvas.polyline(centres[[a, b]][:, [0, 2]], COVIS_RGB)
    canvas.dots(X[:, [0, 2]], LANDMARK_RGB)
    for cid in np.unique(cids[kf_valid]):
        sel = np.flatnonzero(kf_valid & (cids == cid))
        C = centres[sel[np.argsort(ts[sel])]][:, [0, 2]]
        rgb = _rgb(CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)])
        canvas.polyline(C, rgb)
        canvas.dots(C, rgb, radius=2)
    canvas.save(path)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%TITLE%</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;user-select:none}
canvas{display:block}</style></head>
<body><div id="hud">%TITLE% &mdash; drag: orbit, wheel: zoom, shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const DATA = %DATA%;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.6, pitch = 0.4, dist = DATA.radius * 2.5, cx = DATA.center;
let panX = 0, panY = 0;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize', resize);
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if(drag.shift){panX+=dx;panY+=dy;}else{yaw+=dx*0.008;pitch+=dy*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));}
 drag={x:e.clientX,y:e.clientY,shift:drag.shift};draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
function proj(p){
 const x=p[0]-cx[0], y=p[1]-cx[1], z=p[2]-cx[2];
 const cy_=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
 const x1=cy_*x+sy*z, z1=-sy*x+cy_*z;
 const y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<0.05)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2+panX, cv.height/2+f*y2/z2+panY, z2];
}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 for(const p of DATA.points){const s=proj(p);if(!s)continue;
  ctx.fillStyle='#8a8a8a';ctx.fillRect(s[0],s[1],1.5,1.5);}
 for(const tr of DATA.trajs){ctx.strokeStyle=tr.color;ctx.lineWidth=1.6;
  ctx.beginPath();let first=true;
  for(const p of tr.pts){const s=proj(p);if(!s){first=true;continue;}
   if(first){ctx.moveTo(s[0],s[1]);first=false;}else ctx.lineTo(s[0],s[1]);}
  ctx.stroke();
  for(const p of tr.pts){const s=proj(p);if(!s)continue;
   ctx.fillStyle=tr.color;ctx.fillRect(s[0]-1.5,s[1]-1.5,3,3);}}
 for(const e of DATA.edges){const a=proj(e[0]),b=proj(e[1]);if(!a||!b)continue;
  ctx.strokeStyle='rgba(180,180,60,0.8)';ctx.lineWidth=1;
  ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
}
resize();
</script></body></html>
"""


def map_payload(m) -> dict:
    """Viewer payload of one MapState: landmark cloud, per-client KF
    trajectories, loop edges (the reference Viewer publishes the same three
    marker classes, src/Viewer.cpp)."""
    mp_valid = m.mp.valid.cpu().numpy()
    X = m.mp.Xw.cpu().numpy()[mp_valid]
    kf_valid = m.kf.valid.cpu().numpy()
    cids = m.kf.client_id.cpu().numpy()
    ts = m.kf.timestamp.cpu().numpy()
    Tall = m.kf.Tcw.cpu().numpy()
    centers = np.zeros((len(Tall), 3), np.float32)
    centers[kf_valid] = _centres(Tall[kf_valid])
    trajs = []
    for cid in np.unique(cids[kf_valid]):
        sel = np.flatnonzero(kf_valid & (cids == cid))
        sel = sel[np.argsort(ts[sel])]
        trajs.append({
            "color": CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)],
            "pts": centers[sel].round(4).tolist(),
        })
    edges = []
    loop_e = m.kf.loop_edge.cpu().numpy()
    for s in np.flatnonzero(kf_valid & (loop_e >= 0)):
        o = int(loop_e[s])
        if kf_valid[o]:
            edges.append([centers[s].round(4).tolist(),
                          centers[o].round(4).tolist()])
    pts = X[:: max(1, len(X) // 20000)]  # cap payload
    allp = np.concatenate([pts, centers[kf_valid]]) if len(pts) else centers[kf_valid]
    center = allp.mean(0) if len(allp) else np.zeros(3)
    radius = float(np.percentile(
        np.linalg.norm(allp - center, axis=-1), 90)) if len(allp) else 1.0
    return {
        "points": pts.round(4).tolist(),
        "trajs": trajs,
        "edges": edges,
        "center": center.round(4).tolist(),
        "radius": max(radius, 1e-3),
    }


def export_html(m, path: str, title: str = "map") -> None:
    """Standalone interactive 3D map viewer (no external deps — a pure-canvas
    orbit renderer). For a LIVE view while the system runs, see
    ``utils.live_viewer.LiveViewer`` (serves the same renderer over HTTP)."""
    import json

    html = (_HTML_TEMPLATE
            .replace("%TITLE%", title)
            .replace("%DATA%", json.dumps(map_payload(m))))
    with open(path, "w") as f:
        f.write(html)


def render_trajectories(trajs: Dict[int, np.ndarray], path: str,
                        gt: Optional[np.ndarray] = None,
                        title: str = "trajectories") -> None:
    """Plot per-agent camera-center tracks (N, 3) plus optional GT (black)."""
    pts = [C[:, [0, 2]] for C in trajs.values()] + ([gt[:, [0, 2]]] if gt is not None else [])
    canvas = _Canvas(np.concatenate(pts) if pts else np.zeros((0, 2)))
    if gt is not None:
        canvas.polyline(gt[:, [0, 2]], (0, 0, 0))
    for cid, C in trajs.items():
        canvas.polyline(C[:, [0, 2]], _rgb(CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)]))
    canvas.save(path)
