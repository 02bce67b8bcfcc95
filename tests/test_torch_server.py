"""The port's MultiStreamServer (future_od_tpu_torch/serve/server.py) on the
CPU, the counterparts of the unsharded tests of tests/test_server.py:
asynchronous multi-stream micro-batching equals per-stream sessions,
padding is bit for bit inert, streams join and leave, a flooding stream
queues, a random arrival schedule keeps each stream's order, a mixed-IMU
fleet is refused before any bookkeeping, an IMU-less fleet is served; and
the port's server against the JAX server on one arrival schedule, stream by
stream; and the server over a 2-device CPU grid against the unsharded one
and the JAX server on a 2-device data mesh.

The model is tests/test_torch_streaming.py's tiny flagship with JAX
weights (one for the file); frames are 64x96. The JAX server runs eagerly.
About 35 s alone.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from future_od_tpu.serve import MultiStreamServer as JaxServer
from future_od_tpu.serve.server import split_results as jax_split_results

from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.serve import MultiStreamServer, StreamingSession
from future_od_tpu_torch.serve.server import split_results
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_streaming import (
    BOX_ATOL,
    H,
    IMU,
    L,
    SAME_BOX_ATOL,
    SCORE_ATOL,
    W,
    make_twins,
)


@pytest.fixture(scope="module")
def twins():
    return make_twins()


@pytest.fixture(scope="module")
def model(twins):
    return twins("flagship")[2]


def make_frame(rng, imu=True):
    frame = {"video": rng.normal(size=(H, W, 3)).astype(np.float32)}
    if imu:
        for key, d in IMU:
            frame[key] = rng.normal(size=(d,)).astype(np.float32)
    return frame


def server(model, max_batch, **kw):
    return MultiStreamServer(model, max_batch=max_batch, clip_frames=L, device="cpu", **kw)


def session_outputs(model, frames):
    """Reference: one StreamingSession at batch 1 over a stream's frames."""
    session = StreamingSession(model, clip_frames=L, device="cpu")
    outs = []
    for frame in frames:
        out = session.step({k: v[None] for k, v in frame.items()})
        if out is not None:
            outs.append({k: v[0] for k, v in out.items()})
    return outs


def assert_boxes_close(got, want, atol=SAME_BOX_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g["boxes"]), np.asarray(w["boxes"]), rtol=0,
                                   atol=atol)


def test_multistream_matches_per_stream_sessions(model):
    """3 staggered streams through a max_batch=4 server equal each stream
    served alone (the tolerance covers batch 4 against batch 1: a few f32
    ulps of a box, test_torch_streaming.py)."""
    rng = np.random.default_rng(0)
    streams = {sid: [make_frame(rng) for _ in range(4)] for sid in "abc"}
    srv = server(model, 4)
    got = {sid: [] for sid in streams}
    for t in range(4):  # a0 b0 c0 a1 ...: batches of 4 cut across streams
        for sid in "abc":
            for rsid, out in split_results(srv.submit(sid, streams[sid][t])):
                got[rsid].append(out)
    for rsid, out in split_results(srv.flush()):
        got[rsid].append(out)
    assert srv.stats()["frames"] == 12
    for sid in streams:
        assert len(got[sid]) == 3  # clips end at t=1,2,3
        assert_boxes_close(got[sid], session_outputs(model, streams[sid]))


def test_padding_is_bitwise_inert(model):
    """A stream served in padded partial batches gives bit for bit the
    outputs of the same stream sharing its batches with another: no op
    mixes batch rows."""
    rng = np.random.default_rng(1)
    frames = [make_frame(rng) for _ in range(3)]
    other = [make_frame(rng) for _ in range(3)]
    solo = server(model, 4)
    solo_outs = []
    for f in frames:  # 1 real row + 3 pad rows a dispatch
        solo_outs += [o for _, o in split_results(solo.submit("x", f) + solo.flush())]
    assert solo.stats()["pad_fraction"] == pytest.approx(0.75)
    mixed = server(model, 4)
    mixed_outs = []
    for f, g in zip(frames, other):
        res = mixed.submit("x", f) + mixed.submit("y", g) + mixed.flush()
        mixed_outs += [o for sid, o in split_results(res) if sid == "x"]
    assert len(solo_outs) == len(mixed_outs) == 2
    for s, m in zip(solo_outs, mixed_outs):
        for key in ("boxes", "class_scores"):
            np.testing.assert_array_equal(s[key].numpy(), m[key].numpy())


def test_stream_join_leave(model):
    """close_stream drops the cached window: a rejoining stream warms up
    from scratch."""
    rng = np.random.default_rng(2)
    srv = server(model, 2)
    assert split_results(srv.submit("a", make_frame(rng)) + srv.flush()) == []
    outs = srv.submit("a", make_frame(rng)) + srv.flush()
    assert [sid for sid, _ in split_results(outs)] == ["a"]
    srv.close_stream("a")
    assert srv.stats()["active_streams"] == 0
    assert split_results(srv.submit("a", make_frame(rng)) + srv.flush()) == []


def test_flooding_stream_queues(model):
    """Frames of ONE stream submitted back to back spread over padded
    rounds, one frame a dispatch; every clip comes back, each against its
    own ring window."""
    rng = np.random.default_rng(3)
    frames = [make_frame(rng) for _ in range(4)]
    srv = server(model, 4)
    outs = []
    for f in frames:  # one distinct stream: nothing dispatches until flush
        outs += [o for _, o in split_results(srv.submit("s", f))]
    outs += [o for _, o in split_results(srv.flush())]
    assert srv.stats()["dispatches"] == 4
    assert len(outs) == 3
    assert_boxes_close(outs, session_outputs(model, frames))


def test_random_arrival_schedule_matches_sessions(model):
    """Staggered joins, bursts and an early leave: every stream's clips,
    in its frame order, equal its session's."""
    rng = np.random.default_rng(5)
    n_frames = {"a": 5, "b": 4, "c": 3, "d": 4}
    streams = {s: [make_frame(rng) for _ in range(n)] for s, n in n_frames.items()}
    schedule = ["a", "a", "b", "c", "a", "b", "d", "c", "b", "a", "d",
                "c", "b", "d", "a", "d"]
    assert {s: schedule.count(s) for s in n_frames} == n_frames
    srv = server(model, 3, max_streams=8)
    sent = {s: 0 for s in n_frames}
    got = {s: [] for s in n_frames}
    for s in schedule:
        res = srv.submit(s, streams[s][sent[s]])
        sent[s] += 1
        for rsid, out in split_results(res):
            got[rsid].append(out)
        if s == "c" and sent[s] == n_frames["c"]:
            # drain, then drop "c" mid-run; later dispatches are unaffected
            for rsid, out in split_results(srv.flush()):
                got[rsid].append(out)
            srv.close_stream("c")
    for rsid, out in split_results(srv.flush()):
        got[rsid].append(out)
    for s in n_frames:
        assert len(got[s]) == n_frames[s] - 1
        assert_boxes_close(got[s], session_outputs(model, streams[s]))


def test_mixed_imu_streams_rejected_before_bookkeeping(model):
    rng = np.random.default_rng(0)
    srv = server(model, 2)
    srv.submit("a", make_frame(rng))  # opens the server with IMU
    with pytest.raises(ValueError, match="IMU"):
        srv.submit("b", make_frame(rng, imu=False))
    assert "b" not in srv._streams  # no state left behind
    for _ in range(L):
        srv.submit("a", make_frame(rng))
        srv.submit("c", make_frame(rng))
    assert srv.flush()


def test_imu_less_fleet_served(model):
    """A fleet opened without IMU is served (no egodeep ring), and a late
    joiner with IMU is refused."""
    rng = np.random.default_rng(1)
    srv = server(model, 2)
    outs = []
    for _ in range(L + 1):
        outs += srv.submit("a", make_frame(rng, imu=False))
        outs += srv.submit("b", make_frame(rng, imu=False))
    outs += srv.flush()
    assert outs and srv._ego_ring is None
    with pytest.raises(ValueError, match="IMU"):
        srv.submit("late", make_frame(rng))


def test_server_equals_jax_server(twins):
    """The port's server and the JAX server (eager) on one arrival
    schedule: the same placements, and each stream's clips equal (the port
    against the JAX package: test_torch_streaming.py's bounds)."""
    jmodel, variables, port = twins("flagship")
    rng = np.random.default_rng(6)
    n_frames = {"a": 3, "b": 3, "c": 2}
    streams = {s: [make_frame(rng) for _ in range(n)] for s, n in n_frames.items()}
    schedule = ["a", "b", "a", "c", "b", "c", "a", "b"]
    ours, theirs = server(port, 2), JaxServer(jmodel, variables, max_batch=2, clip_frames=L,
                                              jit=False)
    got = {s: [] for s in n_frames}
    want = {s: [] for s in n_frames}
    sent = {s: 0 for s in n_frames}
    for s in schedule:
        frame = streams[s][sent[s]]
        sent[s] += 1
        mine = ours.submit(s, frame)
        ref = theirs.submit(s, {k: jnp.asarray(v) for k, v in frame.items()})
        assert [p for p, _ in mine] == [p for p, _ in ref]
        for rsid, out in split_results(mine):
            got[rsid].append(out)
        for rsid, out in jax_split_results(ref):
            want[rsid].append(out)
    for rsid, out in split_results(ours.flush()):
        got[rsid].append(out)
    for rsid, out in jax_split_results(theirs.flush()):
        want[rsid].append(out)
    assert ours.stats() == theirs.stats()
    for s in n_frames:
        assert len(got[s]) == len(want[s]) == n_frames[s] - 1
        for g, w in zip(got[s], want[s]):
            np.testing.assert_allclose(g["class_scores"].numpy(), np.asarray(w["class_scores"]),
                                       rtol=0, atol=SCORE_ATOL)
            np.testing.assert_allclose(g["boxes"].numpy(), np.asarray(w["boxes"]), rtol=0,
                                       atol=BOX_ATOL)


def test_mesh_waits_for_parallel(model):
    """What the sharded server still refuses: a mesh with a model axis
    (tensor parallelism, ROADMAP.md Queue 1 item 4b), and a batch or a ring
    that does not divide by the data axis (the JAX server asserts)."""
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 4b"):
        MultiStreamServer(model, max_batch=2, clip_frames=L,
                          mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="divide by the data axis 2"):
        MultiStreamServer(model, max_batch=3, clip_frames=L, mesh=cpu_grid(2))
    with pytest.raises(ValueError, match="divide by the data axis 2"):
        MultiStreamServer(model, max_batch=2, max_streams=5, clip_frames=L, mesh=cpu_grid(2))


def test_sharded_server_matches_unsharded(twins):
    """The counterpart of tests/test_server.py::test_sharded_server_matches_unsharded
    on a 2-device CPU grid: 8 streams pinned 4 and 4 to the devices (each its
    ring shard and 4 rows of every dispatch) give the unsharded server's
    outputs (the other batch shape: test_torch_streaming.py's bound) and
    the JAX server's on a 2-device data mesh, with the same placements."""
    from jax.sharding import NamedSharding, PartitionSpec

    from future_od_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmodel, variables, port = twins("flagship")
    rng = np.random.default_rng(4)
    streams = {sid: [make_frame(rng) for _ in range(3)] for sid in range(8)}

    def run(server, wrap=lambda f: f):
        got, placements = {}, []
        for t in range(3):
            for sid in streams:
                res = server.submit(sid, wrap(streams[sid][t]))
                placements += [p for p, _ in res]
                for rsid, out in split_results(res):
                    got.setdefault(rsid, []).append(out)
        res = server.flush()
        placements += [p for p, _ in res]
        for rsid, out in split_results(res):
            got.setdefault(rsid, []).append(out)
        return got, placements

    ours, placed = run(MultiStreamServer(port, max_batch=8, clip_frames=L, max_streams=16,
                                         mesh=cpu_grid(2)))
    ref, _ = run(server(port, 8, max_streams=16))
    mesh = jax_make_mesh(num_data=2, num_model=1)
    jax_vars = jax.device_put(variables, NamedSharding(mesh, PartitionSpec()))
    theirs, jax_placed = run(JaxServer(jmodel, jax_vars, max_batch=8, clip_frames=L,
                                       max_streams=16, mesh=mesh),
                             lambda f: {k: jnp.asarray(v) for k, v in f.items()})
    assert placed == jax_placed
    assert {row // 4 for p in placed for _, row in p} == {0, 1}  # both devices served
    assert set(ours) == set(ref) == set(theirs) == set(streams)
    for sid in streams:
        assert len(ours[sid]) == len(ref[sid]) == len(theirs[sid]) == 2  # clips end at t=1,2
        assert_boxes_close(ours[sid], ref[sid])
        for g, w in zip(ours[sid], theirs[sid]):
            np.testing.assert_allclose(g["class_scores"].numpy(), np.asarray(w["class_scores"]),
                                       rtol=0, atol=SCORE_ATOL)
            np.testing.assert_allclose(g["boxes"].numpy(), np.asarray(w["boxes"]), rtol=0,
                                       atol=BOX_ATOL)


def cpu_grid(n):
    """A mesh of n devices listing the CPU n times (the JAX tests' virtual
    CPU devices)."""
    return make_mesh(n, 1, devices=["cpu"] * n)
