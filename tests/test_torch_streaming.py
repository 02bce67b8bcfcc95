"""The port's streaming path (future_od_tpu_torch/serve/streaming.py)
against the JAX package on the CPU: `StreamingSession` equals the JAX
batch inference and the JAX session on the same clip (encode_offset off and
on), the window slides over a 5-frame stream, a model without the IMU is
served, and every core the per-frame cache cannot serve (a joint encoder,
the single-frame and tracker cores) is refused; the JAX session's joint-
encoder fault is pinned; a session sharded over a 2-device CPU grid equals
the unsharded one and the JAX session sharded over a 2-device mesh.

The model is the JAX tests' tiny flagship (tests/test_streaming.py: D=32, 2
heads, 1+2 layers, 8 queries) on 64x96 frames. Its JAX variables are
`jax.eval_shape` of the init filled from a numpy seed
(tests/test_torch_variants.py::random_variables), carried into the port by
utils/jax_weights.py; one model per configuration for the whole file. The
JAX side runs eagerly (op by op). About 55 s alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.models import build as jax_build
from future_od_tpu.models.cores import FuturePredCore as JaxFuturePredCore
from future_od_tpu.models.st_detr import SpatioTemporalDETR as JaxDETR
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.serve import StreamingSession as JaxSession
from future_od_tpu.train.step import make_inference_fn as jax_make_inference_fn

from future_od_tpu_torch.models import build
from future_od_tpu_torch.models.cores import FuturePredCore
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from future_od_tpu_torch.serve import StreamingSession, make_streaming_fns
from future_od_tpu_torch.train.step import make_inference_fn
from future_od_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_variants import random_variables

TINY = dict(num_classes=3, num_queries=8, hidden_dim=32, nheads=2, enc_nheads=2,
            dim_feedforward=64, enc_layers=1, dec_layers=2, lr_backbone=1e-4, dropout=0.0)
H, W, L = 64, 96, 3
IMU = [("translation", 3), ("acceleration", 3), ("rotation", 4), ("rotation_rate", 3),
       ("speed", 1)]
FRAME_KEYS = ("video",) + tuple(k for k, _ in IMU)
# The port against the JAX package, f32 on both sides: scores (sigmoids) and
# boxes in pixels of a 96-wide frame, test_torch_variants.py's bounds
# (measured there at most 1.3e-6 and 7.6e-5 px).
SCORE_ATOL, BOX_ATOL = 1e-5, 2e-3
# The port's session against its own batch path: the same math on another
# fold of the batch (B frames against B·2), a few f32 ulps of each value
# (boxes reach 128 px, where an ulp is 7.6e-6).
SAME_SCORE_ATOL, SAME_BOX_ATOL = 1e-6, 4e-5


def make_data(rng, B, frames, imu=True):
    """A numpy batch of `frames`-frame clips, the JAX tests' keys."""
    data = {"video": rng.normal(size=(B, frames, H, W, 3)).astype(np.float32),
            "annotated_frame_idx": np.full((B,), frames - 1),
            "temporal_offsets": np.tile(np.linspace(-0.5 * (frames - 1), 0, frames,
                                                    dtype=np.float32), (B, 1))}
    if imu:
        for key, d in IMU:
            data[key] = rng.normal(size=(B, frames, d)).astype(np.float32)
    return data


def frame_at(data, t):
    """Frame t of a batch: {"video": (B, H, W, 3), IMU keys: (B, d)}."""
    return {k: data[k][:, t] for k in FRAME_KEYS if k in data}


def jnp_tree(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def jax_imu_off(args):
    core = JaxFuturePredCore(separate_encoder=jax_build._separate_encoder(args, use_imu=False),
                             detector=jax_build._detector(args, 2))
    return JaxDETR(core=core, args=args)


def port_imu_off(args):
    core = FuturePredCore(build._separate_encoder(args, use_imu=False),
                          build._detector(args, 2, use_egodeep=False))
    return build.assemble(core, args, device="cpu")


# name -> (JAX model, port model) of (JAX args, port args)
MODELS = {
    "flagship": lambda a, p: (jax_build.build_flagship(a), build.build_flagship(p, device="cpu")),
    "imu off": lambda a, p: (jax_imu_off(a), port_imu_off(p)),
    "joint": lambda a, p: (jax_build.build_with_joint_encoder(a, "joint"),
                           build.build_with_joint_encoder(p, "joint", device="cpu")),
}


def make_twins():
    """get(name, encode_offset=False) -> (JAX model, JAX variables, the port
    model with those weights), each built on first use (encode_offset
    changes no parameter: both share one variables tree)."""
    cache, trees = {}, {}

    def get(name, encode_offset=False):
        if (name, encode_offset) not in cache:
            kw = dict(TINY, encode_offset=encode_offset)
            jmodel, port = MODELS[name](JaxArgs(**kw), SpatioTemporalDETRArgs(**kw))
            if name not in trees:
                batch = jnp_tree(make_data(np.random.default_rng(0), 1, L))
                trees[name] = random_variables(
                    jax.eval_shape(lambda: jmodel.init(jax.random.key(0), batch)))
            cache[(name, encode_offset)] = (jmodel, trees[name],
                                            load_jax_variables(port, trees[name]))
        return cache[(name, encode_offset)]
    return get


@pytest.fixture(scope="module")
def twins():
    return make_twins()


def assert_close(out, ref, score_atol=SCORE_ATOL, box_atol=BOX_ATOL):
    out = {k: np.asarray(v) for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert out["boxes"].shape == ref["boxes"].shape
    np.testing.assert_allclose(out["class_scores"], ref["class_scores"], rtol=0, atol=score_atol)
    np.testing.assert_allclose(out["boxes"], ref["boxes"], rtol=0, atol=box_atol)


def run_session(session, data, frames, offsets=False):
    out = None
    for t in range(frames):
        out = session.step(frame_at(data, t), float(data["temporal_offsets"][0, t])
                           if offsets else 0.0)
    return out


def first_clip(data):
    """Clip 0 of a batch, as a batch of one."""
    return {k: v[:1] for k, v in data.items()}


@pytest.mark.parametrize("encode_offset", [False, True])
def test_session_equals_batch_and_jax(twins, encode_offset):
    """The session's output after the clip's L-1 past frames equals the
    port's batch path (2 clips), and on the first clip the JAX batch path
    and the JAX session (the JAX side at batch 1: one shape to compile)."""
    jmodel, variables, port = twins("flagship", encode_offset)
    data = make_data(np.random.default_rng(1), 2, L)
    session = StreamingSession(port, clip_frames=L, device="cpu")
    assert session.step(frame_at(data, 0)) is None
    out = session.step(frame_at(data, 1),
                       float(data["temporal_offsets"][0, 1]) if encode_offset else 0.0)
    assert_close(out, make_inference_fn(port, device="cpu")(data),
                 SAME_SCORE_ATOL, SAME_BOX_ATOL)
    first = {k: v[:1] for k, v in out.items()}
    clip = jnp_tree(first_clip(data))
    assert_close(first, jax_make_inference_fn(jmodel)(variables, clip))
    jax_session = JaxSession(jmodel, variables, clip_frames=L, jit=False)
    assert_close(first, run_session(jax_session, clip, L - 1, offsets=encode_offset))


def test_window_slides(twins):
    """A 5-frame stream: outputs from the second frame on, each equal to the
    batch path (the port's and JAX's) on the clip ending at that frame."""
    jmodel, variables, port = twins("flagship")
    stream = make_data(np.random.default_rng(2), 1, 5)
    session = StreamingSession(port, clip_frames=L, device="cpu")
    infer, jax_infer = make_inference_fn(port, device="cpu"), jax_make_inference_fn(jmodel)
    for t in range(4):
        out = session.step(frame_at(stream, t))
        if t == 0:
            assert out is None
            continue
        clip = {k: (v[:, t - 1:t + 2] if v.ndim > 1 else v) for k, v in stream.items()}
        assert_close(out, infer(clip), SAME_SCORE_ATOL, SAME_BOX_ATOL)
        assert_close(out, jax_infer(variables, jnp_tree(clip)))
    session.reset()
    assert session.step(frame_at(stream, 0)) is None


def test_model_without_imu(twins):
    """A FuturePredCore built without the IMU (no IMU MLP, no egodeep):
    frames without IMU keys, against the JAX batch path."""
    jmodel, variables, port = twins("imu off")
    data = make_data(np.random.default_rng(3), 1, L, imu=False)
    encode, _ = make_streaming_fns(port, L)
    with torch.inference_mode():
        assert encode({"video": torch.from_numpy(data["video"][:, 0])})[1] is None
    out = run_session(StreamingSession(port, clip_frames=L, device="cpu"), data, L - 1)
    assert_close(out, jax_make_inference_fn(jmodel)(variables, jnp_tree(data)))


REFUSED = {
    "joint": lambda p: build.build_with_joint_encoder(p, "joint", device="cpu"),
    "single frame": lambda p: build.build_single_frame(p, device="cpu"),
    "tracker baseline": lambda p: build.build_tracker_baseline(p, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refuses_cores_it_cannot_stream(name):
    """The per-frame cache is the batch path only for drop-the-future,
    encode each frame alone, detect: every other core is refused."""
    model = REFUSED[name](SpatioTemporalDETRArgs(**TINY))
    with pytest.raises(ValueError, match="FuturePredCore without a joint encoder"):
        StreamingSession(model, clip_frames=L, device="cpu")
    with pytest.raises(ValueError, match="FuturePredCore without a joint encoder"):
        make_streaming_fns(model, L)


def test_joint_encoder_streaming_fault_is_pinned(twins):
    """A reference-side fault (ROADMAP.md Queue 3): the JAX session's
    detect (future_od_tpu/serve/streaming.py:71-76) never calls the joint
    encoder, so a `build_with_joint_encoder(args, "joint")` model served
    through it gives other outputs than its batch inference. The port
    refuses the model."""
    jmodel, variables, port = twins("joint")
    data = jnp_tree(make_data(np.random.default_rng(4), 1, L))
    batch = jax_make_inference_fn(jmodel)(variables, data)
    streamed = run_session(JaxSession(jmodel, variables, clip_frames=L, jit=False), data, L - 1)
    gap = np.abs(np.asarray(streamed["boxes"]) - np.asarray(batch["boxes"])).max()
    assert gap > 100 * BOX_ATOL, gap
    with pytest.raises(ValueError, match="joint encoder"):
        StreamingSession(port, clip_frames=L, device="cpu")


def test_input_sharding_waits_for_parallel(twins):
    """What the sharded session refuses: a mesh with a model axis (serving
    takes a model axis of 1, as the JAX server asserts; tensor parallelism
    cuts the training steps only), a sharding other than `batch_sharding`,
    and a frame batch that does not split over the data axis."""
    _, _, port = twins("flagship")
    with pytest.raises(ValueError, match=r"serving takes a model axis of 1"):
        StreamingSession(port, clip_frames=L, input_sharding=batch_sharding(
            make_mesh(1, 2, devices=["cpu", "cpu"])))
    with pytest.raises(TypeError, match="batch_sharding"):
        StreamingSession(port, clip_frames=L, device="cpu", input_sharding=object())
    session = StreamingSession(port, clip_frames=L, input_sharding=batch_sharding(cpu_grid(2)))
    data = make_data(np.random.default_rng(5), 3, L)
    with pytest.raises(ValueError, match="3 rows does not split evenly over a data axis of 2"):
        session.step(frame_at(data, 0))


def cpu_grid(n):
    """A mesh of n devices listing the CPU n times (the JAX tests' virtual
    CPU devices)."""
    return make_mesh(n, 1, devices=["cpu"] * n)


def test_streaming_sharded_dp_mesh(twins):
    """The counterpart of tests/test_streaming.py::test_streaming_sharded_dp_mesh
    on a 2-device CPU grid: 8 lockstep streams split 4 and 4 over the data
    axis (a model replica each) equal the unsharded session (a few f32
    ulps: the other batch shape) and the JAX session with its frames
    sharded over a 2-device data mesh."""
    from future_od_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
    from future_od_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from future_od_tpu.parallel.mesh import replicate as jax_replicate

    jmodel, variables, port = twins("flagship")
    data = make_data(np.random.default_rng(2), 8, L)
    sharded = StreamingSession(port, clip_frames=L, input_sharding=batch_sharding(cpu_grid(2)))
    assert len({id(m) for m in sharded._models}) == 1  # one device listed twice: one replica
    out = run_session(sharded, data, L - 1)
    assert out["boxes"].shape[0] == 8
    assert_close(out, run_session(StreamingSession(port, clip_frames=L, device="cpu"), data,
                                  L - 1), SAME_SCORE_ATOL, SAME_BOX_ATOL)
    mesh = jax_make_mesh(num_data=2, num_model=1)
    jax_session = JaxSession(jmodel, jax.device_put(variables, jax_replicate(mesh)),
                             clip_frames=L, input_sharding=jax_batch_sharding(mesh))
    assert_close(out, run_session(jax_session, jnp_tree(data), L - 1))
