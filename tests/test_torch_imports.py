"""Import guard for the torch port: every module of
motioncheck_ccm_slam_tpu_torch imports without pulling in jax or any module
of the JAX package, and none imports triton at module level (the CPU test
host has no triton). The port's copy of the config holds the JAX package's
operating points."""
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
                  "triton": "triton" in top}))
"""


def test_port_imports_no_jax_and_no_triton():
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
            "models.tracking", "parallel.sharded_ba")
    }
    assert expected <= set(out["modules"]), expected - set(out["modules"])
    assert out["jax"] == []
    assert out["jax_package"] is False
    assert out["triton"] is False


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


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU."""
    for fn in (tentry.entry, tentry.gba_entry, tmap.empty_mp_block):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    t = ttrack.Tracker(config=tconfig.DEFAULT_CONFIG, map=None)
    assert t.device == torch.device("cuda")
