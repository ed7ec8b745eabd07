"""Live stream transport (dataio/stream.py): protocol round-trip, backlog
shedding, and the multi-process producer -> `run_slam --listen` online
mode under deliberate backpressure (VERDICT r3 missing #3)."""

import json
import os
import subprocess
import sys
import threading

import numpy as np

from msf_loam_tpu.dataio.npz_bag import ImuMsg, OdomMsg, ScanMsg
from msf_loam_tpu.dataio.stream import StreamServer, StreamWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _roundtrip(addr):
    server = StreamServer(addr, accept_timeout=20)
    sent = [
        ImuMsg(time=0.01, acc=np.array([0.1, 0.2, 9.8], np.float32),
               gyr=np.array([0.0, 0.01, 0.02], np.float32)),
        OdomMsg(time=0.05, t=np.array([1.0, 2.0, 3.0], np.float32),
                q_wxyz=np.array([1.0, 0, 0, 0], np.float32)),
        ScanMsg(time=0.1,
                xyz=np.arange(30, dtype=np.float32).reshape(10, 3),
                ring=np.arange(10, dtype=np.int32) % 4),
    ]

    def produce():
        w = StreamWriter(server.address, connect_timeout=20)
        for m in sent:
            w.send(m)
        w.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    got = [m for m, dropped in server.messages()]
    server.close()
    t.join(timeout=10)
    assert len(got) == 3
    np.testing.assert_allclose(got[0].acc, sent[0].acc)
    np.testing.assert_allclose(got[1].t, sent[1].t)
    np.testing.assert_allclose(got[2].xyz, sent[2].xyz)
    np.testing.assert_array_equal(got[2].ring, sent[2].ring)
    assert got[2].time == sent[2].time


def test_stream_roundtrip_tcp():
    _roundtrip("127.0.0.1:0")


def test_stream_roundtrip_unix(tmp_path):
    _roundtrip(f"unix:{tmp_path}/msf.sock")


def test_stream_sheds_stale_scans():
    """A burst of scans arriving while the consumer is busy must shed all
    but the freshest (the reference's real-time drop policy)."""
    server = StreamServer("127.0.0.1:0", accept_timeout=20)

    def produce():
        w = StreamWriter(server.address, connect_timeout=20)
        for i in range(8):
            w.send(ScanMsg(time=0.1 * i,
                           xyz=np.zeros((5, 3), np.float32),
                           ring=np.zeros(5, np.int32)))
        w.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    # wait_eof: deterministic maximum-backlog drain (no reader-thread race)
    out = list(server.messages(wait_eof=True))
    server.close()
    t.join(timeout=10)
    assert len(out) == 8
    dropped = [m.time for m, d in out if d]
    kept = [m.time for m, d in out if not d]
    assert len(dropped) == 7              # whole backlog sheds but one
    assert kept == [max(m.time for m, _ in out)]  # the freshest survives


def test_stream_producer_consumer_e2e(tmp_path):
    """Producer process streams synthetic frames wall-clock-paced at a
    consumer running the FULL CLI (`run_slam --listen`). The pacing is
    deliberately faster than the consumer's jit-compile stall, so frames
    MUST shed; the platform holds still through the warm-up (a real
    bringup) and then moves, and the surviving frames must still track gt
    (gt pairing is by timestamp, so dropped scans drop their gt rows)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO}
    addr = f"unix:{tmp_path}/msf.sock"
    step = 0.1
    warmup, frames = 30, 55
    consumer = subprocess.Popen(
        [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
         "--listen", addr, "--eval", "--quiet",
         "--n_rings", "16", "--output_dir", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # 2 Hz frame cadence: compile (~10 s) eats the static warm-up, the
    # post-warmup motion is sustainable (~0.4 s/frame on CPU)
    producer = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "stream_producer.py"),
         "--addr", addr, "--selftest", "--frames", str(frames),
         "--warmup_static", str(warmup), "--step", str(step),
         "--speed", "0.2"],
        env=env, capture_output=True, timeout=300, text=True)
    assert producer.returncode == 0, producer.stderr[-2000:]
    out, err = consumer.communicate(timeout=300)
    assert consumer.returncode == 0, out[-2000:] + err[-2000:]
    summary = json.loads(out.strip().splitlines()[-1])
    # deliberate backpressure: the compile stall forces shedding
    assert summary["dropped_scans"] > 0, summary
    assert summary["frames"] >= 4, summary

    # recovery: the last processed frames track gt displacement
    with np.load(tmp_path / "trajectory.npz") as z:
        times, est = z["times"], z["translation"]

    def gt_at(tm):
        j = max(0, int(round(tm / 0.1)) - warmup)
        return np.array([step * j, 0.1 * np.sin(0.2 * j), 0.0])

    tail = min(4, len(times) - 1)
    for a in range(len(times) - tail, len(times)):
        d_est = est[a] - est[a - 1]
        d_gt = gt_at(times[a]) - gt_at(times[a - 1])
        np.testing.assert_allclose(d_est, d_gt, atol=0.08)
    # absolute error stays bounded (no drift accumulated through sheds)
    assert np.linalg.norm(est[-1] - gt_at(times[-1])) < 0.3, (
        est[-1], gt_at(times[-1]))


def test_stream_malformed_producer_terminates():
    """Garbage bytes (bad magic) or a mid-message hangup must end the
    stream cleanly — the consumer yields what it got and returns, never
    hangs or raises."""
    import socket

    server = StreamServer("127.0.0.1:0", accept_timeout=20)

    def produce():
        host, port = server.address.rsplit(":", 1)
        s = socket.socket()
        s.connect((host, int(port)))
        # one valid message, then garbage magic, then hangup
        s.sendall(__import__("msf_loam_tpu.dataio.stream",
                             fromlist=["_encode"])._encode(
            ImuMsg(time=1.0, acc=np.zeros(3, np.float32),
                   gyr=np.zeros(3, np.float32))))
        s.sendall(b"JUNKJUNKJUNK")
        s.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    got = list(server.messages())
    server.close()
    t.join(timeout=10)
    assert len(got) == 1 and isinstance(got[0][0], ImuMsg)


def test_stream_truncated_message_terminates():
    import socket
    import struct

    from msf_loam_tpu.dataio.stream import MAGIC

    server = StreamServer("127.0.0.1:0", accept_timeout=20)

    def produce():
        host, port = server.address.rsplit(":", 1)
        s = socket.socket()
        s.connect((host, int(port)))
        # header promises 1000 payload bytes, delivers 10, hangs up
        s.sendall(struct.pack("<4sBI", MAGIC, 1, 1000) + b"x" * 10)
        s.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    got = list(server.messages())
    server.close()
    t.join(timeout=10)
    assert got == []


def test_stream_out_of_order_scan_dropped(tmp_path):
    """A live stream cannot be re-sorted: the CLI must drop a scan whose
    stamp steps backward (network reordering) instead of feeding the IMU
    window slicer a negative interval (VERDICT r5 #8)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "s.sock")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": repo}
    consumer = subprocess.Popen(
        [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
         "--listen", "unix:" + sock, "--quiet", "--n_rings", "4",
         "--output_dir", str(tmp_path / "out")],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    import time as _time

    import numpy as np

    from msf_loam_tpu.dataio.npz_bag import ScanMsg
    from msf_loam_tpu.dataio.stream import StreamWriter

    for _ in range(100):
        if os.path.exists(sock):
            break
        _time.sleep(0.2)
    w = StreamWriter("unix:" + sock, connect_timeout=30)
    rng = np.random.default_rng(0)

    def scan(t):
        xyz = rng.uniform(1, 5, (4, 256, 3)).astype(np.float32).reshape(-1, 3)
        ring = np.repeat(np.arange(4, dtype=np.int32), 256)
        return ScanMsg(time=t, xyz=xyz, ring=ring)

    # t=0.3 arrives after t=0.4: must be dropped, not processed. The
    # first scan pays the jit compile (~15 s on CPU), so pace the sends
    # generously — a backlogged scan would be SHED (a different, also
    # valid, drop path) instead of exercising the monotonicity guard.
    w.send(scan(0.1))
    _time.sleep(40.0)          # absorb compile
    for t in (0.2, 0.4, 0.3, 0.5):
        w.send(scan(t))
        _time.sleep(4.0)
    w.close()
    out, err = consumer.communicate(timeout=240)
    assert consumer.returncode == 0, out[-2000:] + err[-2000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert "out-of-order" in err, err[-1500:]
    assert summary["frames"] == 4, (summary, err[-1000:])
