"""The port's command line on the CPU.

- ``cli.main(["synth", "--agents", "2", "--frames", "36", "--small",
  "--device", "cpu", ...])`` meets the JAX package's fixture outcome
  (``VERDICT.md``): one merge, both agents OK, each agent's ATE <= 0.10 m
  (JAX's: ~5.7 cm), no silent watchdog module, and the output files (the
  map image decoded by the port's own PNG reader).
- ``euroc --synth-camera --small --device cpu`` replays an ASL directory
  synthesised as tests/test_euroc.py builds it.
- With ``--device cuda`` (the default) and no card, every subcommand
  raises before it starts.
- Every subcommand takes the JAX CLI's arguments, with its defaults but
  the output directory's, plus ``--device``.

The two agents of the shared world see the same frames at the same times,
so the synth run memoises the plain versions of K1 and K2 (pure functions
of the pyramid; on the CPU they are ~85% of an agent's frame) by their
input bytes: the second agent's extraction takes the first one's results.
"""
import argparse
import functools
import json
import os
import sys

import pytest
import torch

import jax

from motioncheck_ccm_slam_tpu import cli as jcli
from motioncheck_ccm_slam_tpu_torch import cli
from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda
from motioncheck_ccm_slam_tpu_torch.utils import png

import test_euroc
import torch_one_thread  # noqa: F401 (torch on one thread)

MAX_ATE_M = 0.10
EUROC_FRAMES = 12


def memoised(fn):
    """fn over a list of CPU level tensors, memoised by their bytes; a hit
    returns clones."""
    cache = {}

    @functools.wraps(fn)
    def call(levels, **kw):
        key = (tuple(lv.numpy().tobytes() for lv in levels), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = fn(levels, **kw)
        out = cache[key]
        return [o.clone() if torch.is_tensor(o) else tuple(x.clone() for x in o) for o in out]

    return call


@pytest.fixture(scope="module")
def synth_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    saved = fast_cuda.masked_corner_score_levels, fast_cuda.blur_and_moments_levels
    fast_cuda.masked_corner_score_levels = memoised(saved[0])
    fast_cuda.blur_and_moments_levels = memoised(saved[1])
    try:
        stats = cli.main(["synth", "--agents", "2", "--frames", "36", "--small",
                          "--device", "cpu", "--out", out])
    finally:
        fast_cuda.masked_corner_score_levels, fast_cuda.blur_and_moments_levels = saved
    return out, stats


def test_synth_merges_the_two_agents(synth_run):
    _, stats = synth_run
    assert stats["n_merges"] == 1
    assert stats["watchdog_silent"] == []
    assert len(stats["server_maps"]) == 1
    assert stats["server_maps"][0]["kfs"] >= 6


@pytest.mark.parametrize("cid", [0, 1])
def test_synth_agent_ok_and_accurate(synth_run, cid):
    _, stats = synth_run
    a = stats["agents"][cid]
    assert a["state"] == "OK" and a["frames"] == 36
    assert a["ate_rmse_m"] <= MAX_ATE_M, a


def test_synth_writes_its_outputs(synth_run):
    out, stats = synth_run
    names = set(os.listdir(out))
    assert {"stats.json", "frames_client0.tum", "frames_client1.tum", "KF_FINAL_0.tum",
            "KF_FINAL_1.tum", "map_0.html", "map_0.png"} <= names, names
    with open(os.path.join(out, "stats.json")) as f:
        on_disk = json.load(f)
    assert set(on_disk) == {"wall_s", "n_merges", "watchdog_silent", "peak_rss_mb", "comm",
                            "agents", "n_gba_interrupts", "server_maps"}
    assert on_disk["agents"]["1"]["ate_rmse_m"] == stats["agents"][1]["ate_rmse_m"]
    rows = open(os.path.join(out, "frames_client0.tum")).read().split("\n")
    assert len([r for r in rows if r.strip()]) == 36
    img = png.read_png(os.path.join(out, "map_0.png"))
    assert img.ndim == 3 and img.shape[2] == 3 and (img != 255).any()


@pytest.fixture(scope="module")
def euroc_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_seq"))
    out = str(tmp_path_factory.mktemp("euroc_out"))
    test_euroc._write_fixture(root)
    stats = cli.main(["euroc", "--seq", root, "--frames", str(EUROC_FRAMES), "--small",
                      "--synth-camera", "--device", "cpu", "--out", out])
    return out, stats


def test_euroc_replay_tracks_and_exports(euroc_run):
    out, stats = euroc_run
    assert stats["agents"][0]["state"] == "OK"
    assert stats["agents"][0]["frames"] == EUROC_FRAMES
    assert stats["agents"][0]["client_kfs"] >= 2
    for name in ("frames_client0.tum", "KF_FINAL_0.tum", "map_0.png", "stats.json"):
        assert os.path.exists(os.path.join(out, name)), name
    # the Sim3-aligned ATE against the ASL ground truth (test_euroc's bound)
    assert stats["ate_rmse_m"] < 0.06, stats


@pytest.mark.parametrize("argv", [
    ["synth", "--frames", "1"],
    ["serve", "--port", "0", "--timeout", "1"],
    ["agent", "--connect", "127.0.0.1:9"],
    ["euroc", "--seq", "no-such-dir"],
    ["kitti", "--seq", "no-such-dir"],
], ids=lambda a: a[0])
def test_device_cuda_without_a_card_raises(argv, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cuda"):
        cli.main(argv + ["--out", str(tmp_path)] if argv[0] != "agent" else argv)
    assert not os.listdir(tmp_path)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def subcommand_options(main, monkeypatch) -> dict:
    """subcommand -> {option: (default, nargs, type)} of the parser that
    ``main`` builds, caught at its parse_args."""
    def catch(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    monkeypatch.setattr(sys, "argv", ["cli"])
    try:
        main()
    except _Parsed as e:
        parser = e.parser
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {opt: (a.default, a.nargs, a.type) for a in sp._actions
                   for opt in a.option_strings if opt not in ("-h", "--help")}
            for name, sp in sub.choices.items()}


def test_subcommands_take_the_jax_arguments(monkeypatch):
    # the JAX main() sets its compile cache before it parses: restore it
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        j = subcommand_options(jcli.main, monkeypatch)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    t = subcommand_options(cli.main, monkeypatch)
    assert sorted(t) == sorted(j) == ["agent", "euroc", "kitti", "serve", "synth"]
    for name in j:
        assert t[name].pop("--device") == ("cuda", None, None)
        assert t[name].keys() == j[name].keys(), name
        for opt in j[name]:
            if opt != "--out":
                assert t[name][opt] == j[name][opt], (name, opt)
        if "--out" in j[name]:
            assert t[name]["--out"][0].endswith(os.path.join("build", "cli", "server" if name ==
                                                             "serve" else name))
