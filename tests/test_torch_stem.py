"""The stem slice of the port against the JAX package, on the CPU.

- The stem-study kernels' plain versions (future_od_tpu_torch/ops/
  stem_variants.py, reached through the ported tool's stem_a/b/b16/d)
  against the Pallas kernels of tools/bench_stem.py in interpret mode (the
  tool is loaded from its file and not edited), at the tool's check shape,
  f32 and bf16; the ported tool's `--check`.
- The space-to-depth helpers (models/resnet.py, data/loader.py) against
  JAX's, bit for bit.
- The flagship's space-to-depth stem: a tiny `space_to_depth=True` flagship
  in the port, from bridged JAX weights, against the JAX model on a
  host-packed f32 video. The same numbers must come from the port on the
  unpacked video and on its uint8 source (normalized on the device), packed
  or not, and from a 7x7 port model under FUTURE_OD_S2D_STEM=1 whose kernel
  w7 the JAX model's conv1 is the transform of: the JAX gate computes
  exactly that conv (resnet.py:478-483), so one JAX compile serves all.
"""
import importlib.util
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from future_od_tpu.data.loader import host_space_to_depth as jax_host_space_to_depth
from future_od_tpu.models import resnet as jax_resnet
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train.step import make_inference_fn as jax_make_inference_fn

from future_od_tpu_torch.data.loader import host_space_to_depth
from future_od_tpu_torch.models import resnet as port_resnet
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.resnet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    s2d4_stem_pool,
    space_to_depth4,
    stem_weights_to_s2d4,
)
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.tools import bench_stem
from future_od_tpu_torch.train.step import make_inference_fn
from future_od_tpu_torch.utils.jax_weights import jax_to_state_dict, load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plain version vs Pallas kernel, elementwise: |out - ref| <= RTOL |ref| +
# ATOL max |ref|. f32: the same products summed in another order (D: nine
# tap sums against one). bf16: both sides round an f32 value once, one bf16
# ulp (2^-7 relative) apart at most.
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}
ATOL = 2e-5
TINY = dict(
    num_classes=4, hidden_dim=32, enc_nheads=4, nheads=4, enc_layers=1,
    dec_layers=1, dim_feedforward=48, num_queries=5, dropout=0.0,
)
IMU_SHAPES = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
# as tests/test_torch_flagship.py: scores are sigmoids; boxes are pixels of
# a 64x96 image
SCORE_ATOL, BOX_ATOL = 1e-5, 2e-3
STEM_KEY = "_model.separate_encoder.backbone.body.conv1.weight"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "bench_stem", os.path.join(REPO, "tools", "bench_stem.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_inputs():
    """The TPU tool's check inputs (its check_interpret draws)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=bench_stem.CHECK_SHAPE).astype(np.float32)
    w7 = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)
    return x, w7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["A", "B", "B16", "D"])
def test_plain_versions_match_pallas_interpret(tool, kernel, dtype):
    x, w7 = check_inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw7 = jnp.asarray(x).astype(jdt), jnp.asarray(w7)
    px, pw7 = torch.from_numpy(x).to(dtype), torch.from_numpy(w7)
    if kernel == "D":
        w3 = tool.stem_weights_to_s2d4(jw7).astype(jdt)
        x128 = jnp.pad(tool.space_to_depth4(jx), ((0, 0), (0, 0), (0, 0), (0, 80)))
        ref = tool.pallasD(x128, jnp.pad(w3, ((0, 0), (0, 0), (0, 80), (0, 0))), interpret=True)
        ops = bench_stem.operands(px, pw7)
        out = bench_stem.stem_d(ops["x128"], ops["w3p"])
    else:
        ref = getattr(tool, f"pallas{kernel}")(jx, jw7, interpret=True)
        out = getattr(bench_stem, f"stem_{kernel.lower()}")(px, pw7)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape == (2, 16, 24, 64)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    diff = (out.float() - ref).abs()
    assert bool((diff <= RTOL[dtype] * ref.abs() + ATOL * ref.abs().max()).all()), diff.max()


@pytest.mark.parametrize("kernel", ["a", "b", "b16", "d"])
def test_unwritten_rows_raise(kernel):
    """Hp = 16 is not a multiple of tile_p 5: the TPU kernel would leave the
    last row unwritten; the port refuses."""
    x, w7 = (torch.from_numpy(a) for a in check_inputs())
    if kernel == "d":
        ops = bench_stem.operands(x, w7)
        x, w7 = ops["x128"], ops["w3p"]
    fn = getattr(bench_stem, f"stem_{kernel}")
    assert fn(x, w7, tile_p=16).shape[1] == 16
    with pytest.raises(ValueError, match="not a multiple of tile_p"):
        fn(x, w7, tile_p=5)


def test_port_check():
    records = bench_stem.check()
    assert [r["name"] for r in records] == [
        "xlaim2col", "xla_s2d", "s2d_host", "s2d4_host", "s2d4_p128", "s2d4_im2col",
        "A", "B", "B16", "D"]
    assert bench_stem.main(["--check"]) == 0


class TestSpaceToDepthHelpers:
    def test_space_to_depth4(self, rng):
        x = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
        np.testing.assert_array_equal(space_to_depth4(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax_resnet.space_to_depth4(jnp.asarray(x))))

    def test_stem_weights_to_s2d4(self, rng):
        w7 = rng.normal(size=(7, 7, 3, 64)).astype(np.float32)
        np.testing.assert_array_equal(
            stem_weights_to_s2d4(torch.from_numpy(w7)).numpy(),
            np.asarray(jax_resnet.stem_weights_to_s2d4(jnp.asarray(w7))))

    def test_s2d4_stem_pool(self, rng):
        y = np.maximum(rng.normal(size=(2, 5, 7, 256)), 0).astype(np.float32)
        np.testing.assert_array_equal(s2d4_stem_pool(torch.from_numpy(y)).numpy(),
                                      np.asarray(jax_resnet.s2d4_stem_pool(jnp.asarray(y))))

    def test_host_space_to_depth(self, rng):
        video = rng.integers(0, 256, size=(2, 3, 8, 12, 3), dtype=np.uint8)
        out = host_space_to_depth(video)
        assert out.dtype == np.uint8 and out.shape == (2, 3, 4, 6, 12)
        np.testing.assert_array_equal(out, jax_host_space_to_depth(video))


def normalize(u):
    """The host's normalization of uint8 frames, in device_normalize's op
    order (f32)."""
    mean = np.tile(np.asarray(IMAGENET_MEAN, np.float32), u.shape[-1] // 3)
    std = np.tile(np.asarray(IMAGENET_STD, np.float32), u.shape[-1] // 3)
    return (u.astype(np.float32) / np.float32(255.0) - mean) / std


@pytest.fixture(scope="module")
def s2d_reference():
    """(variables, w7, uint8 clip, IMU dict, JAX output). The JAX
    space_to_depth flagship's conv1 is stem_weights_to_space_to_depth(w7);
    heads randomized and frozen BN jittered so that errors in either cannot
    hide. Its input is the host-packed f32 video of the uint8 clip."""
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, size=(1, 3, 64, 96, 3), dtype=np.uint8)
    imu = {k: rng.normal(size=(1, 3, w)).astype(np.float32) for k, w in IMU_SHAPES.items()}
    batch = {k: jnp.asarray(v) for k, v in
             dict(imu, video=host_space_to_depth(normalize(clip))).items()}
    model = jax_build_flagship(JaxArgs(**TINY, space_to_depth=True))
    variables = jax.tree.map(np.asarray, model.init(jax.random.key(0), batch))
    w7 = (rng.normal(size=(7, 7, 3, 64)) * math.sqrt(2 / (7 * 7 * 64))).astype(np.float32)
    core = variables["params"]["core"]
    core["separate_encoder"]["backbone"]["body"]["conv1"]["kernel"] = np.asarray(
        jax_resnet.stem_weights_to_space_to_depth(jnp.asarray(w7)))
    core["detector"]["bbox_embed"]["layer2"] = {
        "kernel": rng.normal(0, 0.1, (TINY["hidden_dim"], 4)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (4,)).astype(np.float32),
    }
    core["detector"]["class_embed"]["bias"] = rng.normal(
        0, 1.0, (TINY["num_classes"],)).astype(np.float32)
    variables["frozen"] = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), variables["frozen"])
    ref = jax.tree.map(np.asarray, jax_make_inference_fn(model)(variables, batch))
    return variables, w7, clip, imu, ref


def port_s2d_model(variables):
    model = build_flagship(SpatioTemporalDETRArgs(**TINY, space_to_depth=True), device="cpu")
    return load_jax_variables(model, variables)


def assert_matches(out, ref):
    assert out["class_scores"].shape == ref["class_scores"].shape == (1, 1, 1, 5, 5)
    np.testing.assert_allclose(out["class_scores"].numpy(), ref["class_scores"], atol=SCORE_ATOL)
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], atol=BOX_ATOL)


def video_of(clip, kind):
    return {
        "packed f32": lambda: host_space_to_depth(normalize(clip)),
        "f32": lambda: normalize(clip),
        "uint8": lambda: clip,
        "packed uint8": lambda: host_space_to_depth(clip),
    }[kind]()


def counting(monkeypatch, module, name):
    """Wrap module.<name>, recording each call's arguments."""
    calls, original = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


class TestSpaceToDepthFlagship:
    def test_bridged_stem_kernel(self, s2d_reference):
        variables, w7 = s2d_reference[:2]
        weight = jax_to_state_dict(variables, device="cpu")[STEM_KEY]
        assert tuple(weight.shape) == (64, 12, 4, 4)
        model = port_s2d_model(variables)
        assert torch.equal(model.state_dict()[STEM_KEY], weight)

    @pytest.mark.parametrize("kind", ["packed f32", "f32", "uint8", "packed uint8"])
    def test_matches_jax(self, s2d_reference, kind):
        variables, _, clip, imu, ref = s2d_reference
        infer = make_inference_fn(port_s2d_model(variables), device="cpu")
        assert_matches(infer(dict(imu, video=video_of(clip, kind))), ref)

    @pytest.mark.parametrize("kind", ["packed f32", "f32"])
    def test_fused_gates(self, s2d_reference, monkeypatch, kind):
        """The fused stem takes the s2d kernel as it is (BN folded), on the
        packed input; the gate reads the incoming video (64x96, or 32x48
        packed: both pass H % 32 and W % 4)."""
        variables, _, clip, imu, ref = s2d_reference
        monkeypatch.setenv("FUTURE_OD_FUSED_RESNET", "1")
        monkeypatch.setenv("FUTURE_OD_FUSED_STEM", "1")
        stem = counting(monkeypatch, port_resnet, "fused_stem_packed")
        transform = counting(monkeypatch, port_resnet, "stem_weights_to_space_to_depth")
        model = port_s2d_model(variables)
        infer = make_inference_fn(model, device="cpu")
        assert_matches(infer(dict(imu, video=video_of(clip, kind))), ref)
        assert len(stem) == 1 and not transform
        scale, _ = model._model.separate_encoder.backbone.body.bn1.scale_shift()
        conv1 = model._model.separate_encoder.backbone.body.conv1.weight
        assert stem[0][0].shape == (2, 32, 48, 12)
        assert torch.equal(stem[0][1].w4, conv1.permute(2, 3, 1, 0) * scale)

    def test_fused_gate_reads_the_incoming_video(self, s2d_reference, monkeypatch):
        """At 96x96 the unpacked video passes the gate (96 % 32 == 0); its
        packing (48x48) does not, so it takes the plain stem: the JAX
        package's gate picks the same paths. Both equal the gates-off
        forward."""
        variables, _, _, imu, _ = s2d_reference
        clip = np.random.default_rng(1).integers(0, 256, size=(1, 3, 96, 96, 3), dtype=np.uint8)
        infer = make_inference_fn(port_s2d_model(variables), device="cpu")
        plain = infer(dict(imu, video=clip))
        monkeypatch.setenv("FUTURE_OD_FUSED_RESNET", "1")
        monkeypatch.setenv("FUTURE_OD_FUSED_STEM", "1")
        for video, launches in ((clip, 1), (host_space_to_depth(clip), 0)):
            stem = counting(monkeypatch, port_resnet, "fused_stem_packed")
            out = infer(dict(imu, video=video))
            assert len(stem) == launches
            np.testing.assert_allclose(out["class_scores"].numpy(),
                                       plain["class_scores"].numpy(), atol=SCORE_ATOL)
            np.testing.assert_allclose(out["boxes"].numpy(), plain["boxes"].numpy(),
                                       atol=BOX_ATOL)

    @pytest.mark.parametrize("gate", ["1", "0"])
    def test_s2d_stem_gate_on_a_7x7_model(self, s2d_reference, monkeypatch, gate):
        """A 7x7 model with kernel w7 under FUTURE_OD_S2D_STEM=1 runs the
        s2d conv with the transformed kernel, as the JAX gate does; with the
        gate shut its 7x7/2 conv gives the same numbers."""
        variables, w7, clip, imu, ref = s2d_reference
        model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
        sd = jax_to_state_dict(variables, device="cpu")
        sd[STEM_KEY] = torch.from_numpy(w7).permute(3, 2, 0, 1)
        model.load_state_dict(sd, strict=True)
        monkeypatch.setenv("FUTURE_OD_S2D_STEM", gate)
        transform = counting(monkeypatch, port_resnet, "stem_weights_to_space_to_depth")
        assert_matches(make_inference_fn(model, device="cpu")(dict(imu, video=normalize(clip))),
                       ref)
        assert len(transform) == int(gate)


@pytest.mark.parametrize("flag", ["int8_backbone", "int8_static"])
def test_int8_backbone_not_built_silently(flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        build_flagship(SpatioTemporalDETRArgs(**TINY, **{flag: True}), device="cpu")
