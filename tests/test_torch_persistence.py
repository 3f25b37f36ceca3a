"""Port parity: persistence.py and ServerSystem.save_maps / add_loaded_map
against the JAX package.

A map is built with numpy (seeded, with holes among the valid slots and
both client ids) and held by both packages. Each package's ``save_map``
writes the same npz keys with bitwise-equal arrays of the same dtypes and
the same ``.index.json``; a file saved by either package loads in the
other with every array bitwise equal and the host index equal.
``add_loaded_map`` in both packages' servers, from one file, gives the
same handler id, rewritten client ids, ``mp_tick``, matcher rows and
database entries (BoW rows within test_torch_placerec's 1e-6). The port
interleaves the ids of a file's several clients in the handler's one
namespace (id * n + the client's rank), so that ids repeated across
clients (a merged map's) stay distinct: every saved keyframe mounts. The
JAX package keeps the ids as they are, and the host index then keeps one
keyframe of each repeated id.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu import config as jconfig, persistence as jpersist
from motioncheck_ccm_slam_tpu.models import map_state as jms
from motioncheck_ccm_slam_tpu.system.server import ServerSystem as JServer
from motioncheck_ccm_slam_tpu_torch import convert, persistence as tpersist
from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem as TServer

from test_torch_gba_driver import port_config
from test_torch_placerec import BOW_ATOL
import torch_one_thread  # noqa: F401 (torch on one thread)

NK, NM, F = 16, 96, 64
J_CONFIG = jconfig.Config().replace(
    extractor=jconfig.ExtractorParams(max_features=F, n_features=F),
    capacity=jconfig.CapacityParams(client_max_kfs=NK, client_max_mps=NM,
                                    server_max_kfs=NK, server_max_mps=NM))
T_CONFIG = port_config(J_CONFIG)


def numpy_blocks(seed: int = 0, repeat_ids: bool = False):
    """(kf, mp) dicts of numpy arrays in the blocks' dtypes: 10 KF slots
    in use less a hole at 3, 70 landmark slots less every 9th, clients 0
    and 1 alternating; with ``repeat_ids`` both clients number their
    keyframes and landmarks from 0 (as two merged agents do)."""
    rng = np.random.default_rng(seed)
    kf_valid = np.zeros(NK, bool)
    kf_valid[:10] = True
    kf_valid[3] = False
    mp_valid = np.zeros(NM, bool)
    mp_valid[:70] = True
    mp_valid[::9] = False
    mp_idx = np.where(rng.random((NK, F)) < 0.5, rng.integers(0, NM, (NK, F)), -1)
    mp_idx = np.where(mp_valid[np.maximum(mp_idx, 0)] & (mp_idx >= 0), mp_idx, -1)

    def poses(n):
        T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        T[:, :3, :3] += rng.normal(0, 0.01, (n, 3, 3)).astype(np.float32)
        T[:, :3, 3] = rng.normal(0, 1, (n, 3)).astype(np.float32)
        return T

    i32 = np.int32
    kf_ids = np.arange(NK) // 2 if repeat_ids else np.arange(NK) + 100
    mp_ids = np.arange(NM) // 2 if repeat_ids else np.arange(NM) + 1000
    kf = dict(
        kf_id=np.where(kf_valid, kf_ids, -1).astype(i32),
        client_id=np.where(kf_valid, np.arange(NK) % 2, -1).astype(i32),
        unique_id=np.where(kf_valid, np.arange(NK) + 1, 0).astype(i32),
        timestamp=(np.arange(NK) * 0.05).astype(np.float32),
        Tcw=poses(NK), xy=rng.uniform(0, 700, (NK, F, 2)).astype(np.float32),
        angle=rng.uniform(-3, 3, (NK, F)).astype(np.float32),
        octave=rng.integers(0, 8, (NK, F)).astype(i32),
        desc=rng.integers(0, 2**32, (NK, F, 8), dtype=np.uint32),
        feat_valid=rng.random((NK, F)) < 0.9, mp_idx=mp_idx.astype(i32),
        parent=np.where(kf_valid, np.arange(NK) - 1, -1).astype(i32),
        pred=np.where(kf_valid, np.arange(NK) - 1, -1).astype(i32), valid=kf_valid,
        loop_edge=np.where(np.arange(NK) == 8, 1, -1).astype(i32), Tcw_pre_gba=poses(NK),
        tracking_tws=rng.normal(0, 1, (NK, 3)).astype(np.float32))
    mp = dict(
        mp_id=np.where(mp_valid, mp_ids, -1).astype(i32),
        client_id=np.where(mp_valid, np.arange(NM) % 2, -1).astype(i32),
        unique_id=np.where(mp_valid, np.arange(NM) + 500, 0).astype(i32),
        Xw=rng.normal(0, 3, (NM, 3)).astype(np.float32),
        desc=rng.integers(0, 2**32, (NM, 8), dtype=np.uint32),
        normal=rng.normal(0, 1, (NM, 3)).astype(np.float32),
        min_dist=rng.uniform(0.1, 1, NM).astype(np.float32),
        max_dist=rng.uniform(5, 9, NM).astype(np.float32),
        ref_kf=rng.integers(0, 10, NM).astype(i32),
        first_kf_id=rng.integers(100, 110, NM).astype(i32),
        n_visible=rng.integers(1, 20, NM).astype(i32),
        n_found=rng.integers(1, 5, NM).astype(i32), valid=mp_valid)
    return kf, mp


def jax_map(seed: int = 0, repeat_ids: bool = False) -> jms.MapState:
    kf, mp = numpy_blocks(seed, repeat_ids)
    m = jms.MapState(kf=jms.KFBlock(**{k: jnp.asarray(v) for k, v in kf.items()}),
                     mp=jms.MPBlock(**{k: jnp.asarray(v) for k, v in mp.items()}),
                     config=J_CONFIG)
    m.sync_host_index()
    m.next_kf_slot, m.next_mp_slot = 10, 70
    return m


def port_map(seed: int = 0, repeat_ids: bool = False):
    return convert.map_state_from_numpy(jax_map(seed, repeat_ids), T_CONFIG, "cpu")


def npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def assert_same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def port_fields(m) -> dict:
    """The port's map as the npz's key -> numpy array."""
    out = {f"kf_{k}": v for k, v in convert.kf_block_to_numpy(m.kf)._asdict().items()}
    out.update({f"mp_{k}": v for k, v in convert.mp_block_to_numpy(m.mp)._asdict().items()})
    return out


def jax_fields(m) -> dict:
    out = {f"kf_{k}": np.asarray(v) for k, v in m.kf._asdict().items()}
    out.update({f"mp_{k}": np.asarray(v) for k, v in m.mp._asdict().items()})
    return out


def host_index(m) -> tuple:
    return m.next_kf_slot, m.next_mp_slot, dict(m.kf_slot_by_id), dict(m.mp_slot_by_id)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    jpath, tpath = str(d / "jax.npz"), str(d / "port.npz")
    jpersist.save_map(jax_map(), jpath)
    tpersist.save_map(port_map(), tpath)
    return jpath, tpath


def test_both_packages_write_the_same_files(saved):
    jpath, tpath = saved
    j, t = npz(jpath), npz(tpath)
    assert_same_arrays(t, j)
    assert sorted(t) == sorted([f"kf_{k}" for k in jms.KFBlock._fields]
                               + [f"mp_{k}" for k in jms.MPBlock._fields])
    assert t["kf_desc"].dtype == np.uint32
    with open(jpath + ".index.json") as f, open(tpath + ".index.json") as g:
        assert json.load(g) == json.load(f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_port_loads_either_file(saved, writer):
    path = saved[0] if writer == "jax" else saved[1]
    m = tpersist.load_map(path, T_CONFIG, device="cpu")
    assert m.device == torch.device("cpu")
    assert m.kf.desc.dtype == torch.int32 and m.kf.mp_idx.dtype == torch.int32
    assert_same_arrays(port_fields(m), npz(path))
    assert host_index(m) == host_index(jax_map())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jax_loads_either_file(saved, writer):
    path = saved[0] if writer == "jax" else saved[1]
    m = jpersist.load_map(path, J_CONFIG)
    assert_same_arrays(jax_fields(m), npz(path))
    assert host_index(m) == host_index(jax_map())


def test_load_without_index_rebuilds_it(saved, tmp_path):
    path = str(tmp_path / "bare.npz")
    shutil.copy(saved[1], path)
    m = tpersist.load_map(path, T_CONFIG, device="cpu")
    j = jpersist.load_map(path, J_CONFIG)
    assert (m.kf_slot_by_id, m.mp_slot_by_id) == (j.kf_slot_by_id, j.mp_slot_by_id)
    assert len(m.kf_slot_by_id) == 9 and len(m.mp_slot_by_id) == 62


def test_load_map_defaults_to_the_card():
    import inspect

    assert inspect.signature(tpersist.load_map).parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def loaded(saved):
    """One file mounted as a prior map by both packages' servers."""
    js = JServer(config=J_CONFIG, n_agents=1)
    ts = TServer(config=T_CONFIG, n_agents=1, device="cpu")
    return js, js.add_loaded_map(saved[0]), ts, ts.add_loaded_map(saved[0])


def test_add_loaded_map_matches_jax(loaded):
    js, jhid, ts, thid = loaded
    assert thid == jhid == 1
    jh, th = js.handlers[jhid], ts.handlers[thid]
    jm, tm = jh.map, th.map
    assert tm.device == torch.device("cpu")
    for name in ("kf_client_id", "mp_client_id", "kf_valid", "mp_valid"):
        block, field = name.split("_", 1)
        np.testing.assert_array_equal(
            getattr(getattr(tm, block), field).numpy(),
            np.asarray(getattr(getattr(jm, block), field)), err_msg=name)
    # the valid entities moved into the handler's client-id namespace
    assert set(tm.kf.client_id.numpy()[tm.kf.valid.numpy()]) == {thid}
    assert (tm.kf.client_id.numpy()[~tm.kf.valid.numpy()] == -1).all()
    # the file's two clients' ids interleaved: id * 2 + the old client id
    kf, mp = numpy_blocks()
    kv, mv = kf["valid"], mp["valid"]
    np.testing.assert_array_equal(tm.kf.kf_id.numpy(),
                                  np.where(kv, kf["kf_id"] * 2 + kf["client_id"], -1))
    np.testing.assert_array_equal(tm.mp.mp_id.numpy(),
                                  np.where(mv, mp["mp_id"] * 2 + mp["client_id"], -1))
    np.testing.assert_array_equal(tm.mp.first_kf_id.numpy(),
                                  np.where(mv, mp["first_kf_id"] * 2 + mp["client_id"],
                                           mp["first_kf_id"]))
    assert sorted(tm.kf_slot_by_id.values()) == sorted(jm.kf_slot_by_id.values())
    assert len(tm.mp_slot_by_id) == len(jm.mp_slot_by_id) == 62
    np.testing.assert_array_equal(th.mp_tick, jh.mp_tick)
    assert set(th.mp_tick) == {-2, -1}
    assert th.comm.agent_said_done and jh.comm.agent_said_done
    assert th.comm.agent_finished and jh.comm.agent_finished
    assert ts.matcher.maps[thid] is tm and ts.channels[thid] is th.channel
    assert ts.matcher.row_of == js.matcher.row_of
    assert ts.matcher.key_of_row == js.matcher.key_of_row


@pytest.mark.parametrize("which", ["matcher", "loop_closer"])
def test_add_loaded_map_database_entries_match_jax(loaded, which):
    js, jhid, ts, thid = loaded
    jdb = js.matcher.db if which == "matcher" else js.handlers[jhid].loop_closer.database
    tdb = ts.matcher.db if which == "matcher" else ts.handlers[thid].loop_closer.database
    jdb._flush()
    tdb._flush()
    np.testing.assert_array_equal(tdb.present.numpy(), np.asarray(jdb.present))
    np.testing.assert_array_equal(tdb.map_id.numpy(), np.asarray(jdb.map_id))
    assert int(tdb.present.sum()) == 9
    np.testing.assert_allclose(tdb.bow.numpy(), np.asarray(jdb.bow), rtol=0, atol=BOW_ATOL)


def test_save_maps_writes_each_distinct_map(loaded, tmp_path):
    _, _, ts, thid = loaded
    paths = ts.save_maps(str(tmp_path / "out"))
    assert [os.path.basename(p) for p in paths] == ["map_0.npz", f"map_{thid}.npz"]
    back = tpersist.load_map(paths[1], T_CONFIG, device="cpu")
    assert_same_arrays(port_fields(back), port_fields(ts.handlers[thid].map))
    assert host_index(back) == host_index(ts.handlers[thid].map)
    # the prior map neither blocks FINALBA nor breaks a server cycle
    ts.spin_once()
    assert ts.handlers[thid].comm.agent_finished


def test_add_loaded_map_mounts_every_entity_of_a_merged_map(tmp_path):
    """Two clients' ids repeat (both from 0): the port's mount keeps every
    keyframe and landmark, with distinct ids in the handler's namespace,
    and puts every keyframe in the matcher and the loop database."""
    path = str(tmp_path / "merged.npz")
    tpersist.save_map(port_map(repeat_ids=True), path)
    ts = TServer(config=T_CONFIG, n_agents=1, device="cpu")
    hid = ts.add_loaded_map(path)
    m = ts.handlers[hid].map
    assert m.n_kfs == 9 and m.n_mps == 62
    ids = m.kf.kf_id.numpy()[m.kf.valid.numpy()]
    assert len(set(ids.tolist())) == 9
    assert len([k for k in ts.matcher.row_of if k[0] == hid]) == 9
    db = ts.handlers[hid].loop_closer.database
    db._flush()
    assert int(db.present.sum()) == 9
