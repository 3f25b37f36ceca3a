"""Import guard for the torch port: every module of
motioncheck_ccm_slam_tpu_torch imports without pulling in jax or any module
of the JAX package, none imports triton at module level (the CPU test
host has no triton), and none imports matplotlib or PIL (the card's
machine has neither). The port's copy of the config holds the JAX
package's operating points. Every port test module runs torch on one
thread (tests/torch_one_thread.py)."""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from motioncheck_ccm_slam_tpu import config as jconfig
from motioncheck_ccm_slam_tpu_torch import config as tconfig
from motioncheck_ccm_slam_tpu_torch import entry as tentry
from motioncheck_ccm_slam_tpu_torch.models import map_state as tmap
from motioncheck_ccm_slam_tpu_torch.models import tracking as ttrack
from motioncheck_ccm_slam_tpu_torch.models import database as tdb, loop_closing as tlc
from motioncheck_ccm_slam_tpu_torch.models import map_matching as tmm, vocabulary as tvoc
from motioncheck_ccm_slam_tpu_torch.system import client as tclient, server as tserver

import torch_one_thread  # noqa: F401 (torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import motioncheck_ccm_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
top = {m.split(".")[0] for m in sys.modules}
print(json.dumps({"modules": names, "jax": sorted(top & {"jax", "jaxlib"}),
                  "jax_package": "motioncheck_ccm_slam_tpu" in top,
                  "triton": "triton" in top, "matplotlib": "matplotlib" in top,
                  "PIL": "PIL" in top}))
"""


def test_port_imports_no_jax_and_no_triton():
    """Also no matplotlib and no PIL, after every port module is imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    expected = {
        "motioncheck_ccm_slam_tpu_torch." + m for m in (
            "config", "convert", "entry", "ops.lie", "ops.geometry", "ops.image",
            "ops.cuda_build", "ops.fast_cuda", "ops.schur_cuda", "ops.orb",
            "ops.matching", "solvers.ba_core", "solvers.pose_opt",
            "solvers.local_ba", "models.map_state", "models.frame",
            "models.tracking", "models.motion_check", "models.gba",
            "parallel.sharded_ba", "ops.ransac", "models.mapping", "system.client",
            "utils.watchdog", "utils.csv_io", "utils.ids", "models.vocabulary",
            "models.database", "models.loop_closing", "models.map_matching",
            "models.map_merging", "solvers.sim3_opt", "solvers.pose_graph",
            "parallel.comm", "system.server", "cli", "persistence", "parallel.codec",
            "parallel.transport", "utils.native", "utils.png", "utils.viewer",
            "utils.live_viewer", "utils.euroc", "utils.kitti", "utils.synth_scene",
            "utils.bigmap")
    }
    assert expected <= set(out["modules"]), expected - set(out["modules"])
    assert out["jax"] == []
    assert out["jax_package"] is False
    assert out["triton"] is False
    assert out["matplotlib"] is False
    assert out["PIL"] is False


@pytest.mark.parametrize("name", ["DEFAULT_CONFIG", "KITTI_CONFIG", "KITTI_HALF_RES_CONFIG"])
def test_config_copy_matches_jax_package(name):
    t, j = getattr(tconfig, name), getattr(jconfig, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for tf, jf in zip(dataclasses.fields(t), dataclasses.fields(j)):
        assert tf.name == jf.name
        np_t, np_j = getattr(t, tf.name), getattr(j, jf.name)
        assert [f.name for f in dataclasses.fields(np_t)] == \
            [f.name for f in dataclasses.fields(np_j)]
    for a, b in ((t.camera.K(), j.camera.K()),
                 (t.camera.dist_coeffs(), j.camera.dist_coeffs())):
        assert a.dtype == b.dtype
        assert (a == b).all()


def test_port_modules_run_torch_on_one_thread():
    """Every port test module imports torch_one_thread, so a process that
    collects any of them runs torch on one thread."""
    assert torch.get_num_threads() == 1
    here = os.path.join(ROOT, "tests")
    for name in sorted(os.listdir(here)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                body = ast.parse(f.read()).body
            imported = {a.name for n in body if isinstance(n, ast.Import) for a in n.names}
            assert "torch_one_thread" in imported, name


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU."""
    for fn in (tentry.entry, tentry.gba_entry, tentry.matrix_free_gba_entry,
               tentry.server_gba_entry, tentry.gba_problem, tentry.server_map,
               tmap.empty_mp_block, tmap.empty_kf_block, tmap.MapState.create,
               tclient.ClientSystem, tserver.ServerSystem, tdb.KeyFrameDatabase,
               tvoc.make_transform):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    t = ttrack.Tracker(config=tconfig.DEFAULT_CONFIG, map=None)
    assert t.device == torch.device("cuda")


def test_server_components_follow_their_maps():
    """LoopCloser and MapMatcher hold no device of their own: their RANSAC
    generators (and the matcher's database) live on their maps' device,
    which MapState.create puts on the card by default. On a CPU map they
    stay on the CPU."""
    for cls in (tlc.LoopCloser, tmm.MapMatcher):
        assert "device" not in inspect.signature(cls).parameters, cls.__name__
    cfg = tconfig.DEFAULT_CONFIG.replace(capacity=tconfig.CapacityParams(
        client_max_kfs=4, client_max_mps=64, server_max_kfs=4, server_max_mps=64))
    m = tmap.MapState.create(cfg, server=True, device="cpu")
    vocab = tvoc.default_vocabulary(k=4, levels=3, n_train=4000)
    closer = tlc.LoopCloser(config=cfg, map=m,
                            database=tdb.KeyFrameDatabase(vocab=vocab, capacity=4, device="cpu"))
    matcher = tmm.MapMatcher(config=cfg, maps={0: m}, vocab=vocab)
    assert closer.generator.device == matcher.generator.device == torch.device("cpu")
    assert matcher.db.bow.device == torch.device("cpu")
