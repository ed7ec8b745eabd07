"""Day-one real-bag compatibility (VERDICT r3 next #6): a byte-exact
NSH-style ROS1 bag — PointCloud2 with ring/time fields in CW ring order,
400 Hz IMU, /odometry_gt — built by scripts/make_nsh_bag.py, validated
with the reference validation script's semantics, and driven through the
FULL CLI (`run_slam --bag ... --loop_closure --eval`)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

FRAMES = 230
_BAG = os.path.join(REPO, ".cache", f"nsh_fixture_v1_{FRAMES}.bag")


@pytest.fixture(scope="module")
def nsh_bag():
    if not os.path.exists(_BAG):
        from make_nsh_bag import build_nsh_bag
        os.makedirs(os.path.dirname(_BAG), exist_ok=True)
        # tests of this file may run in parallel workers: each builds its
        # own temporary file and the atomic rename publishes one of them
        tmp = f"{_BAG}.{os.getpid()}.tmp"
        build_nsh_bag(tmp, frames=FRAMES)
        os.replace(tmp, _BAG)
    return _BAG


def test_fixture_passes_reference_validation(nsh_bag):
    """The reference's validate_velodyne_cloud_in_bag.py semantics: time
    field present, rings ordered by vertical angle, CW point order."""
    from make_nsh_bag import validate_bag

    info = validate_bag(nsh_bag)
    assert info["scans_checked"] >= 3


def test_full_cli_on_nsh_bag(nsh_bag, tmp_path):
    """The complete reference workflow on a real .bag: ingest (bz2 ROS1
    container -> PointCloud2/Imu/Odometry codecs), LIO SLAM, loop
    closure, ATE eval — one subprocess, exactly as a reference user would
    run it."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
         "--bag", nsh_bag, "--loop_closure", "--eval", "--quiet",
         "--n_rings", "16", "--output_dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, timeout=1500, text=True)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["frames"] == FRAMES, summary
    # the courtyard lap revisits its start: loop closure must fire
    assert summary.get("loop_edges", 0) >= 1, summary
    # regression bound: measured 0.057 m ATE / 3 loop edges on the
    # 41.2 m lap (r4); 2x headroom
    assert summary["ate_rmse_m"] < 0.12, summary


def test_multichunk_bz2_roundtrip(tmp_path):
    """A real multi-chunk bz2 bag (rosbag-style chunking) reads back the
    same message stream as the single-chunk form."""
    from make_nsh_bag import build_nsh_bag

    from msf_loam_tpu.dataio.rosbag import read_messages

    one = str(tmp_path / "one.bag")
    many = str(tmp_path / "many.bag")
    build_nsh_bag(one, frames=6, pts_per_ring=300)
    build_nsh_bag(many, frames=6, pts_per_ring=300, chunk_msgs=100)
    msgs_one = [(t, type(m).__name__) for _, t, m in read_messages(one)]
    msgs_many = [(t, type(m).__name__) for _, t, m in read_messages(many)]
    assert len(msgs_one) > 200          # IMU-dominated stream
    assert msgs_one == msgs_many


def test_truncated_bag_terminates_cleanly(tmp_path):
    """Cutting a multi-chunk bag mid-file yields the intact prefix (like a
    rosbag reindex of a crashed recording), not an exception."""
    import warnings

    from make_nsh_bag import build_nsh_bag

    from msf_loam_tpu.dataio.rosbag import read_messages

    full = str(tmp_path / "full.bag")
    build_nsh_bag(full, frames=8, pts_per_ring=300, chunk_msgs=80)
    blob = open(full, "rb").read()
    cut = str(tmp_path / "cut.bag")
    open(cut, "wb").write(blob[: int(len(blob) * 0.6)])
    n_full = sum(1 for _ in read_messages(full))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n_cut = sum(1 for _ in read_messages(cut))
    assert 0 < n_cut < n_full


def test_dropped_and_out_of_order_cli(nsh_bag, tmp_path):
    """Driver frame loss + network reordering: every 8th scan dropped and
    record order shuffled (saved unsorted). The npz conversion heals the
    ordering, the pipeline rides over the gaps, and the loop-closure ATE
    bound still holds (VERDICT r5 #8)."""
    from make_nsh_bag import build_nsh_bag

    bag = str(tmp_path / "rough.bag")
    info = build_nsh_bag(bag, frames=FRAMES, drop_scan_every=8,
                         disorder=True, chunk_msgs=400)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
         "--bag", bag, "--loop_closure", "--eval", "--quiet",
         "--n_rings", "16", "--output_dir", str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, timeout=1500, text=True)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["frames"] == info["frames"], summary
    # 12% frame loss costs some accuracy; the lap must still close sanely
    assert summary["ate_rmse_m"] < 0.25, summary


def test_nsh_64ring_cli(tmp_path):
    """HDL-64-style NSH variant (64 rings) through the full CLI: the
    fixture, reader and pipeline are ring-count-agnostic."""
    from make_nsh_bag import build_nsh_bag

    bag = str(tmp_path / "nsh64.bag")
    build_nsh_bag(bag, frames=24, rings=64, pts_per_ring=500,
                  chunk_msgs=600)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
         "--bag", bag, "--eval", "--quiet",
         "--n_rings", "64", "--output_dir", str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, timeout=1500, text=True)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 24, summary
    assert summary["ate_rmse_m"] < 0.15, summary
