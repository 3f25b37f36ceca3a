"""Port parity for the server -> agent vicinity downlink
(``parallel/comm.ServerComm._pack_vicinity`` and the agent's side that
applies it), which runs only with ``CommParams.server_kfs_to_client > 0``.

- tests/test_vicinity.py:17 on both packages: identical agent and server
  maps, a server-side correction of the newest keyframe, one server tick
  and one agent tick: the agent's copy equals the server's pose (the JAX
  test's bound, 1e-4) and the JAX package's result (1e-5).
- tests/test_sim3_downlink.py:117 on both packages: the agent streams 5
  keyframes up, the server map is fused into another world by a Sim3 of
  scale 1.3, the downlink round trip leaves the agent's poses unchanged
  (2e-3) and a server correction arrives re-metrized by the inverse
  uplink conversion, derived independently (2e-3), as on the JAX side
  (1e-5 between the packages).

The maps are built with numpy (``test_torch_gba_driver.jax_map``, equal
to ``tests/synth_map.add_pass``) and carried across with ``convert``.
"""
import jax.numpy as jnp
import numpy as np
import torch

from motioncheck_ccm_slam_tpu.config import CommParams
from motioncheck_ccm_slam_tpu.models import map_merging as jmerge
from motioncheck_ccm_slam_tpu.models import map_state as jms
from motioncheck_ccm_slam_tpu.parallel import comm as jcomm
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import map_merging as tmerge
from motioncheck_ccm_slam_tpu_torch.models import map_state as tms
from motioncheck_ccm_slam_tpu_torch.parallel import comm as tcomm

from synth_map import SynthWorld, arc_poses
from test_aux import CONFIG as AUX_CONFIG
from test_sim3_downlink import SCALE, _fusion_sim3
from test_torch_gba_driver import jax_map, port_config
import torch_one_thread  # noqa: F401 (torch on one thread)

CONFIG = AUX_CONFIG.replace(comm=CommParams(server_kfs_to_client=8))
T_CONFIG = port_config(CONFIG)


def _kf_poses(m, slot=None):
    T = m.kf.Tcw
    T = T.numpy() if isinstance(T, torch.Tensor) else np.asarray(T)
    return T if slot is None else T[slot]


def _set_pose(m, slot, T):
    if isinstance(m.kf.Tcw, torch.Tensor):
        Tcw = m.kf.Tcw.clone()
        Tcw[slot] = torch.from_numpy(T.astype(np.float32))
    else:
        Tcw = m.kf.Tcw.at[slot].set(jnp.asarray(T.astype(np.float32)))
    m.kf = m.kf._replace(Tcw=Tcw)


def _vicinity_run(pkg):
    """tests/test_vicinity.py's flow on ``pkg`` ("jax" or "port")."""
    world = SynthWorld(CONFIG, n_points=200, seed=0)
    poses, ts = arc_poses(4, step=0.3)
    maps = [jax_map(CONFIG, world, poses, ts, 0) for _ in range(2)]
    if pkg == "port":
        maps = [convert.map_state_from_numpy(m, T_CONFIG, "cpu") for m in maps]
    client_map, server_map = maps
    comm, cfg = (jcomm, CONFIG) if pkg == "jax" else (tcomm, T_CONFIG)
    ch = comm.Channel()
    ccomm = comm.ClientComm(config=cfg, channel=ch, client_id=0)
    scomm = comm.ServerComm(config=cfg, channel=ch, map=server_map, client_id=0)
    newest = server_map.kf_slot_by_id[(3, 0)]
    T_new = _kf_poses(server_map, newest).copy()
    T_new[:3, 3] += np.array([0.05, -0.02, 0.03], np.float32)
    _set_pose(server_map, newest, T_new)
    T_before = _kf_poses(client_map).copy()
    scomm.tick()                  # the server publishes acks and the vicinity
    ccomm.tick(client_map)        # the agent applies the corrections
    return client_map, server_map, newest, T_before


def test_vicinity_poses_flow_back_as_jax():
    cm_t, sm_t, newest, T_before = _vicinity_run("port")
    cm_j, _, _, _ = _vicinity_run("jax")
    slot_c = cm_t.kf_slot_by_id[(3, 0)]
    np.testing.assert_allclose(_kf_poses(cm_t, slot_c), _kf_poses(sm_t, newest), atol=1e-4)
    assert np.abs(_kf_poses(cm_t, slot_c) - T_before[slot_c]).max() > 0.01
    np.testing.assert_allclose(_kf_poses(cm_t), _kf_poses(cm_j), atol=1e-5)


def _mirror(client_map, ccomm, scomm, n=4):
    for _ in range(n):
        ccomm.tick(client_map)
        scomm.tick()
    ccomm.tick(client_map)        # consume the final acks and the vicinity


def _downlink_run(pkg):
    """tests/test_sim3_downlink.py's remetrization flow on ``pkg``; returns
    the agent's poses after the round trip and after the correction, the
    agent's slot of keyframe 4 and the corrected map-frame pose."""
    world = SynthWorld(CONFIG, n_points=250, seed=3)
    poses, ts = arc_poses(5, step=0.3)
    jm = jax_map(CONFIG, world, poses, ts, 0)
    S = _fusion_sim3()
    if pkg == "jax":
        comm, cfg, merge = jcomm, CONFIG, jmerge
        client_map = jm
        server_map = jms.MapState.create(CONFIG, server=True)
        S_dev = jnp.asarray(S.astype(np.float32))
    else:
        comm, cfg, merge = tcomm, T_CONFIG, tmerge
        client_map = convert.map_state_from_numpy(jm, T_CONFIG, "cpu")
        server_map = tms.MapState.create(T_CONFIG, server=True, device="cpu")
        S_dev = torch.from_numpy(S.astype(np.float32))
    ch = comm.Channel()
    ccomm = comm.ClientComm(config=cfg, channel=ch, client_id=0)
    scomm = comm.ServerComm(config=cfg, channel=ch, map=server_map, client_id=0)
    slots_c = [client_map.kf_slot_by_id[(k, 0)] for k in range(5)]
    for s in slots_c:
        ccomm.on_new_keyframe(client_map, s)
    _mirror(client_map, ccomm, scomm)
    merge.sim3_transform_map(server_map, S_dev)
    scomm.compose_fusion_sim3(S)
    assert abs(scomm.map_scale - SCALE) < 1e-3
    T_cli_before = _kf_poses(client_map).copy()
    scomm.tick()
    ccomm.tick(client_map)
    T_round_trip = _kf_poses(client_map).copy()
    newest_s = server_map.kf_slot_by_id[(4, 0)]
    T_new_map = _kf_poses(server_map, newest_s).astype(np.float64)
    T_new_map[:3, 3] += np.array([0.08, -0.03, 0.05])
    _set_pose(server_map, newest_s, T_new_map)
    scomm.tick()
    ccomm.tick(client_map)
    return T_cli_before, T_round_trip, _kf_poses(client_map).copy(), slots_c[-1], T_new_map


def test_downlink_vicinity_remetrizes_after_merge_as_jax():
    T_before, T_round, T_after, slot, T_new_map = _downlink_run("port")
    np.testing.assert_allclose(T_round, T_before, atol=2e-3)
    # the expectation, derived independently: invert the uplink conversion
    S = _fusion_sim3()
    R = S[:3, :3] / SCALE
    exp = np.eye(4)
    exp[:3, :3] = T_new_map[:3, :3] @ R
    exp[:3, 3] = (T_new_map[:3, 3] + T_new_map[:3, :3] @ S[:3, 3]) / SCALE
    np.testing.assert_allclose(T_after[slot], exp.astype(np.float32), atol=2e-3)
    assert np.linalg.norm(T_after[slot][:3, 3] - T_before[slot][:3, 3]) > 0.01
    _, T_round_j, T_after_j, _, _ = _downlink_run("jax")
    np.testing.assert_allclose(T_round, T_round_j, atol=1e-5)
    np.testing.assert_allclose(T_after, T_after_j, atol=1e-5)
