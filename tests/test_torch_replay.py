"""Port parity: the dataset-replay and viewer modules against the JAX
package (and PIL, which exists only on the test host).

- ``utils/png``: decodes PNGs that PIL writes (grayscale and RGB) and
  hand-built files with rows of all five filter types, bitwise; its writer
  round-trips through itself and through PIL; it refuses what it does not
  read and catches a corrupted chunk.
- ``utils/euroc.EurocSequence`` and ``utils/kitti.KittiSequence`` give the
  JAX readers' frames, timestamps, ground truth and ``gt_positions_at`` on
  directories synthesised by tests/test_euroc.py and tests/test_kitti.py.
- ``utils/synth_scene``: poses within POSE_ATOL of tests/synth_scene.py's
  and frames within FRAME_ATOL (see there).
- ``utils/viewer.map_payload`` equals JAX's on one map; ``render_map``,
  ``render_trajectories``, ``export_html`` and ``utils/live_viewer`` write
  and serve it.
"""
import io
import json
import struct
import urllib.request
import zlib

import numpy as np
import pytest
from PIL import Image

from motioncheck_ccm_slam_tpu.config import CameraParams as JCamera, Config as JConfig
from motioncheck_ccm_slam_tpu.utils import viewer as jviewer
from motioncheck_ccm_slam_tpu.utils.euroc import EurocSequence as JEuroc
from motioncheck_ccm_slam_tpu.utils.kitti import KittiSequence as JKitti
from motioncheck_ccm_slam_tpu_torch.config import CameraParams as TCamera, Config as TConfig
from motioncheck_ccm_slam_tpu_torch.utils import live_viewer, png, synth_scene, viewer
from motioncheck_ccm_slam_tpu_torch.utils.euroc import EurocSequence as TEuroc
from motioncheck_ccm_slam_tpu_torch.utils.kitti import KittiSequence as TKitti

import synth_scene as jsynth
import test_euroc
import test_kitti
from test_torch_persistence import jax_map, port_map
import torch_one_thread  # noqa: F401 (torch on one thread)

# tests/synth_scene.py and the port's copy give bitwise-equal poses and
# frames: the port's pose is a float32 numpy copy of se3_exp whose sin and
# cos are correctly rounded on the scene's angles, as JAX's are (torch's
# cos is not always, and at the scene's ~0.01 rad yaw the float32
# cancellation in (1 - cos) / theta^2 turns one ulp into ~1e-5 of
# translation, and the rendered blob edges into ~0.08 grey levels); the
# rendering is the same numpy code on the same poses.
POSE_ATOL = 1e-6
FRAME_ATOL = 0.0
PINHOLE = dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def seeded_image(shape, seed=0):
    """Smooth ramps plus noise, so PIL's adaptive filtering picks varied
    row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 128 + 60 * np.sin(xx / 17.0) + 40 * np.cos(yy / 9.0)
    if len(shape) == 3:
        base = base[..., None] + np.array([0.0, 30.0, -30.0])
    return (base + rng.normal(0, 8, shape)).clip(0, 255).astype(np.uint8)


def pil_png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def png_filter_types(data: bytes) -> set:
    """The row filters a PNG's rows use (an 8-bit grayscale or RGB file)."""
    off, idat = 8, b""
    while off < len(data):
        n = struct.unpack(">I", data[off:off + 4])[0]
        if data[off + 4:off + 8] == b"IDAT":
            idat += data[off + 8:off + 8 + n]
        off += 12 + n
    w, h, _, color = struct.unpack(">IIBB", data[16:26])
    stride = w * (1 if color == 0 else 3) + 1
    return set(zlib.decompress(idat)[::stride][:h])


@pytest.mark.parametrize("shape", [(480, 752), (120, 200, 3), (7, 5), (1, 1)])
def test_png_reads_what_pil_writes(shape):
    img = seeded_image(shape, seed=len(shape))
    data = pil_png(img)
    out = png.decode_png(data)
    assert out.dtype == np.uint8 and out.shape == img.shape
    assert np.array_equal(out, img)
    if shape == (480, 752):
        assert len(png_filter_types(data)) >= 3          # PIL mixed its filters


def filter_rows(img: np.ndarray, types) -> bytes:
    """The PNG row filters of the specification, pixel by pixel in Python:
    row r takes filter types[r % len(types)]."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = [bytes(img[r].reshape(-1)) for r in range(h)]
    out = bytearray()
    prev = bytes(len(rows[0]))
    for r, row in enumerate(rows):
        t = types[r % len(types)]
        out.append(t)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x - pred) % 256)
        prev = row
    return bytes(out)


def handmade_png(img: np.ndarray, types) -> bytes:
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    idat = zlib.compress(filter_rows(img, types))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00an ancillary chunk")
            + chunk(b"IDAT", idat[:10]) + chunk(b"IDAT", idat[10:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)])
@pytest.mark.parametrize("shape", [(23, 31), (9, 13, 3)])
def test_png_reads_every_row_filter(types, shape):
    img = seeded_image(shape, seed=7)
    data = handmade_png(img, types)
    assert png_filter_types(data) == set(types)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)   # a valid file
    assert np.array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("shape", [(480, 752), (31, 17, 3)])
def test_png_writer_roundtrips(shape, tmp_path):
    img = seeded_image(shape, seed=3)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert png_filter_types(open(path, "rb").read()) == {0}


def test_png_refuses_what_it_does_not_read():
    for img in (np.zeros((4, 4), np.uint16), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4), np.float32)):
        with pytest.raises(ValueError):
            png.encode_png(img)
    with pytest.raises(ValueError, match="unsupported"):
        png.decode_png(pil_png(np.zeros((4, 4, 4), np.uint8)))            # RGBA
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="unsupported"):
        png.decode_png(buf.getvalue())                                     # palette
    data = bytearray(png.encode_png(seeded_image((8, 8))))
    data[45] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


# ---------------------------------------------------------------------------
# Dataset readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_seq"))
    test_euroc._write_fixture(root)
    return root


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    return test_kitti._write_fixture(str(tmp_path_factory.mktemp("kitti_root")))


def assert_same_stream(t_frames, j_frames):
    t_frames, j_frames = list(t_frames), list(j_frames)
    assert len(t_frames) == len(j_frames) > 0
    for (ta, ia), (tb, ib) in zip(t_frames, j_frames):
        assert ta == tb
        assert ia.dtype == ib.dtype == np.float32 and ia.shape == ib.shape
        assert np.array_equal(ia, ib)


@pytest.mark.parametrize("window", [dict(), dict(start=3, stop=11, stride=3)])
def test_euroc_reader_matches_jax(euroc_dir, window):
    t, j = TEuroc(euroc_dir), JEuroc(euroc_dir)
    assert len(t) == len(j) == test_euroc.N_FRAMES
    assert t.entries == j.entries
    assert_same_stream(t.frames(**window), j.frames(**window))
    gt = t.ground_truth()
    assert gt.dtype == np.float64 and np.array_equal(gt, j.ground_truth())
    stamps = np.array([e[0] for e in t.entries]) * 1e-9 + 0.013
    np.testing.assert_array_equal(t.gt_positions_at(stamps), j.gt_positions_at(stamps))


@pytest.mark.parametrize("window", [dict(), dict(start=2, stop=40, stride=4)])
def test_kitti_reader_matches_jax(kitti_dir, window):
    t, j = TKitti(kitti_dir), JKitti(kitti_dir)
    assert len(t) == len(j) == test_kitti.N_FRAMES
    assert t.poses_path == j.poses_path is not None
    np.testing.assert_array_equal(t.times, j.times)
    assert_same_stream(t.frames(**window), j.frames(**window))
    np.testing.assert_array_equal(t.ground_truth(), j.ground_truth())
    stamps = t.times[:5] + 0.037
    np.testing.assert_array_equal(t.gt_positions_at(stamps), j.gt_positions_at(stamps))


@pytest.mark.parametrize("window", [dict(stop=1), dict(start=2, stop=40, stride=4)])
def test_kitti_half_res_matches_jax(kitti_dir, window):
    """Half resolution: the port's numpy copy of Pillow's default bicubic
    downscale gives the JAX reader's frames bitwise."""
    t, j = TKitti(kitti_dir, half_res=True), JKitti(kitti_dir, half_res=True)
    full = next(TKitti(kitti_dir).frames(stop=1))[1]
    t_frames = list(t.frames(**window))
    assert t_frames[0][1].shape == (full.shape[0] // 2, full.shape[1] // 2)
    assert_same_stream(t_frames, j.frames(**window))


@pytest.mark.parametrize("shape,size", [
    ((376, 1241), (620, 188)),        # KITTI 00-02 at half resolution
    ((375, 1242), (621, 187)),
    ((480, 752, 3), (376, 240)),      # RGB, as the reader meets it before its grey mean
    ((101, 203), (67, 33)),           # a third
    ((7, 9), (18, 10)),               # upscaling
])
def test_resize_bicubic_matches_pil(shape, size):
    """``kitti.resize_bicubic`` is Pillow's ``Image.resize`` with its
    default filter, bitwise, on noise and on hard 0/255 edges (where the
    kernel's negative lobes clip)."""
    from motioncheck_ccm_slam_tpu_torch.utils.kitti import resize_bicubic

    rng = np.random.default_rng(sum(shape))
    for img in (rng.integers(0, 256, shape, dtype=np.uint8),
                np.where(rng.random(shape) < 0.5, 0, 255).astype(np.uint8)):
        got = resize_bicubic(img, *size)
        assert got.dtype == np.uint8
        assert np.array_equal(got, np.asarray(Image.fromarray(img).resize(size)))


# ---------------------------------------------------------------------------
# Synthetic scene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["wall", "ring"])
def test_synth_scene_matches_tests_synth_scene(kind):
    jc, tc = JConfig().replace(camera=JCamera(**PINHOLE)), TConfig().replace(
        camera=TCamera(**PINHOLE))
    if kind == "wall":
        j = jsynth.SynthScene(jc, n_points=700, seed=3, speed=0.9)
        t = synth_scene.SynthScene(tc, n_points=700, seed=3, speed=0.9)
    else:
        j = jsynth.RingScene(jc, seed=3, start_deg=120.0)
        t = synth_scene.RingScene(tc, seed=3, start_deg=120.0)
    for k in range(200):                                   # 10 s at 20 fps
        Tj, Tt = j.pose(k / 20.0), t.pose(k / 20.0)
        assert Tt.dtype == Tj.dtype == np.float32
        assert np.abs(Tt - Tj).max() <= POSE_ATOL, k
    for (tj, Tj, Ij), (tt, Tt, It) in zip(j.sequence(6), t.sequence(6)):
        assert tj == tt
        assert It.dtype == Ij.dtype and It.shape == Ij.shape == (480, 752)
        assert np.abs(It - Ij).max() <= FRAME_ATOL


def test_synth_scene_se3_exp_matches_the_port_lie():
    """The numpy copy is the port's se3_exp up to float32 rounding where
    no cancellation amplifies it (angles of 0.1-1 rad)."""
    import torch

    from motioncheck_ccm_slam_tpu_torch.ops import lie

    rng = np.random.default_rng(0)
    for xi in np.concatenate([rng.normal(0, 0.5, (20, 6)), np.zeros((1, 6))]).astype(np.float32):
        np.testing.assert_allclose(synth_scene.se3_exp(xi),
                                   lie.se3_exp(torch.from_numpy(xi)).numpy(), atol=2e-6)


# ---------------------------------------------------------------------------
# Viewers
# ---------------------------------------------------------------------------

def test_map_payload_matches_jax():
    t, j = viewer.map_payload(port_map()), jviewer.map_payload(jax_map())
    assert t == j
    assert len(t["trajs"]) == 2 and len(t["edges"]) == 1 and len(t["points"]) == 62


def test_render_and_export(tmp_path):
    m = port_map()
    viewer.render_map(m, str(tmp_path / "map.png"), show_covis=True)
    img = png.read_png(str(tmp_path / "map.png"))
    assert img.shape == (viewer.HEIGHT, viewer.WIDTH, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    for c in viewer.CLIENT_COLORS[:2]:
        assert viewer._rgb(c) in colours                   # both clients' keyframes
    assert viewer.LANDMARK_RGB in colours
    viewer.render_trajectories({0: np.cumsum(np.ones((5, 3)), 0)}, str(tmp_path / "t.png"),
                               gt=np.zeros((5, 3)))
    assert png.read_png(str(tmp_path / "t.png")).shape == (viewer.HEIGHT, viewer.WIDTH, 3)
    viewer.export_html(m, str(tmp_path / "map.html"), title="t")
    j = tmp_path / "j.html"
    jviewer.export_html(jax_map(), str(j), title="t")
    assert (tmp_path / "map.html").read_text() == j.read_text()


def test_live_viewer_serves_the_payload():
    lv = live_viewer.LiveViewer(port=0)
    try:
        lv.update({"server": port_map()})
        with urllib.request.urlopen(lv.url + "state.json", timeout=10) as r:
            got = json.loads(r.read())
        want = viewer.map_payload(port_map())
        assert got["seq"] == 1
        assert got["points"] == want["points"] and got["trajs"] == want["trajs"]
        with urllib.request.urlopen(lv.url, timeout=10) as r:
            assert b"/state.json" in r.read()
    finally:
        lv.close()
