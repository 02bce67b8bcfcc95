"""Export of the port's serving programs (future_od_tpu_torch/serve/
export.py) on the CPU, the counterparts of tests/test_export.py: a batch
program round-trips through bytes and through a file and equals the eager
forward bit for bit, refuses a wrong shape, keeps K1-K3 as `fod::` nodes in
its graph and takes a checkpoint with `load_state_dict`; the streaming pair
equals the live pair and the session; the int8 flagship's program (the int8
PTQ backbone, dynamic) equals its eager forward bit for bit with K8's 53
`fod::int8_conv` nodes and K9's 49 `fod::int8_channel_range` and 53
`fod::int8_quantize` nodes in its graph, and an
uncalibrated static-int8 model is refused; each op's CPU implementation is
its plain function and its fake implementation gives the real output's
shape and dtype.

The model is tests/test_torch_streaming.py's tiny flagship with JAX weights
(the eager port is held against the JAX package there). Every gate is set
for the whole file so that the tiny model reaches all three kernels:
FUTURE_OD_FLASH_MIN_KEYS/_QUERIES=1 (the encoder's self-attention and the
decoder's image attentions), FUTURE_OD_FUSED_RESNET=1 (layer1's and
layer2's stride-1 blocks) and FUTURE_OD_FUSED_STEM=1. On the CPU each op
runs its plain version. One export of each program for the file; about
80 s alone (each ResNet-50 artifact holds 97 MB of weights).
"""
import copy
import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.ops import fused_resnet as fr
from future_od_tpu_torch.ops import int8_conv as k8
from future_od_tpu_torch.ops.flash_attention import reference_attention
from future_od_tpu_torch.serve import (
    StreamingSession,
    export_inference,
    export_streaming,
    load_serving,
    make_streaming_fns,
)
from future_od_tpu_torch.train.step import make_inference_fn
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_streaming import TINY, L, frame_at, make_data, make_twins

GATES = {"FUTURE_OD_FLASH_MIN_KEYS": "1", "FUTURE_OD_FLASH_MIN_QUERIES": "1",
         "FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}
# the tiny flagship's kernel calls a forward under GATES: 1 encoder
# self-attention + 2 decoder layers x 2 image attentions (the first frame's
# dead decoder pass is skipped); layer1's 3 and layer2's 3 stride-1 blocks
# (the tiny frames' layer2 is 8 high); the stem
KERNEL_NODES = {"fod.flash_attention.default": 5, "fod.fused_bottleneck.default": 6,
                "fod.fused_stem.default": 1}


@pytest.fixture(scope="module", autouse=True)
def gates():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in GATES.items():
            mp.setenv(name, value)
        yield


@pytest.fixture(scope="module")
def model():
    return make_twins()("flagship")[2]


@pytest.fixture(scope="module")
def data():
    return make_data(np.random.default_rng(0), 2, L)


@pytest.fixture(scope="module")
def artifact(model, data, tmp_path_factory):
    """(the batch program's bytes, the file it was also written to)."""
    path = tmp_path_factory.mktemp("export") / "infer.pt2"
    return export_inference(model, data, path=str(path)), path


@pytest.fixture(scope="module")
def served(artifact):
    return load_serving(artifact[0], device="cpu")


def tensors(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def assert_equal(out, ref):
    assert set(out) == set(ref)
    for key in ref:
        torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)


def test_inference_roundtrip_bytes_and_file(model, data, artifact, served):
    """Loaded from its bytes and from the file, the program gives the eager
    forward's outputs bit for bit."""
    want = make_inference_fn(model, device="cpu")(data)
    with torch.inference_mode():
        assert_equal(served(tensors(data)), want)
        assert_equal(load_serving(str(artifact[1]), device="cpu")(tensors(data)), want)


def test_graph_keeps_the_kernels(served):
    """K1, K2 and K3 stay in the exported graph as their ops: no plain
    version was traced in a kernel's place."""
    names = [str(n.target) for n in served.graph.nodes if n.op == "call_function"]
    assert {k: names.count(k) for k in KERNEL_NODES} == KERNEL_NODES


def test_export_enforces_shapes(data, served):
    bad = dict(tensors(data), video=torch.from_numpy(data["video"][:, :, :32]))
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        with torch.inference_mode():
            served(bad)


def test_artifact_takes_a_checkpoint(model, data, artifact):
    """The weights are the artifact's state: a checkpoint of the same
    shapes loads with load_state_dict, and the fused blocks' packs, computed
    in the graph, follow it."""
    other = copy.deepcopy(model)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.01)
    program = load_serving(artifact[0], device="cpu")
    program.load_state_dict(other.state_dict())
    with torch.inference_mode():
        got = program(tensors(data))
    want = make_inference_fn(other, device="cpu")(data)
    assert_equal(got, want)
    assert not torch.equal(want["boxes"], make_inference_fn(model, device="cpu")(data)["boxes"])


def test_streaming_pair_matches_live_pair_and_session(model, data):
    encode_blob, detect_blob = export_streaming(model, frame_at(data, 0), clip_frames=L)
    encode, detect = load_serving(encode_blob, device="cpu"), load_serving(detect_blob,
                                                                           device="cpu")
    live_encode, live_detect = make_streaming_fns(model, L, image_hw=data["video"].shape[2:4])
    session = StreamingSession(model, clip_frames=L, device="cpu")
    feats, egos = [], []
    with torch.inference_mode():
        for t in range(L - 1):
            frame = {k: torch.from_numpy(v) for k, v in frame_at(data, t).items()}
            got_f, got_e = encode(frame)
            want_f, want_e = live_encode(frame)
            torch.testing.assert_close(got_f, want_f, rtol=0, atol=0)
            torch.testing.assert_close(got_e, want_e, rtol=0, atol=0)
            feats.append(got_f)
            egos.append(got_e)
        features, egodeep = torch.stack(feats, 1), torch.stack(egos, 1)
        offsets = features.new_zeros(features.shape[:2])
        got = detect(features, egodeep, offsets)
        assert_equal(got, live_detect(features, egodeep, offsets))
    for t in range(L - 1):
        want = session.step(frame_at(data, t))
    assert_equal(got, want)


def int8_model(model, **flags):
    """The tiny flagship's twin with the int8 backbone flags, its weights."""
    twin = build_flagship(SpatioTemporalDETRArgs(**TINY, **flags), device="cpu")
    missing, unexpected = twin.load_state_dict(model.state_dict(), strict=False)
    assert not unexpected and all(k.endswith("_amax") for k in missing)
    return twin.eval()


def test_export_int8_backbone_roundtrip(model, data, monkeypatch):
    """The int8 program exports and reloads like the float one (under the
    default gates, so every trunk convolution is int8): bit for bit the
    eager forward, each of the trunk's 53 convolutions a `fod::int8_conv`
    node a frame batch, its input's codes a `fod::int8_quantize` node and
    its range a `fod::int8_channel_range` node (a block's conv1 and
    downsample share one: 49), the smoothing's reductions (amax over the
    per-channel ranges and the weights) traced in."""
    for name in ("FUTURE_OD_FUSED_RESNET", "FUTURE_OD_FUSED_STEM"):
        monkeypatch.delenv(name)
    int8 = int8_model(model, int8_backbone=True)
    served = load_serving(export_inference(int8, data), device="cpu")
    names = [str(n.target) for n in served.graph.nodes if n.op == "call_function"]
    assert names.count("fod.int8_conv.default") == 53
    assert names.count("fod.int8_quantize.default") == 53
    assert names.count("fod.int8_channel_range.default") == 49
    assert any("amax" in name for name in names)
    with torch.inference_mode():
        assert_equal(served(tensors(data)), make_inference_fn(int8, device="cpu")(data))
    with pytest.raises(ValueError, match="uncalibrated"):
        export_inference(int8_model(model, int8_static=True), data)


def int8_conv_case(rng, dtype):
    q = torch.from_numpy(rng.integers(-128, 128, size=(1, 9, 11, 16)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 16, 64)).astype(np.int8))
    w, zp = k8.pack_int8_weights(wq), k8.zero_point_correction(wq)
    sw = torch.from_numpy(rng.uniform(0, 1e-3, size=64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    geo = ((2, 2), ((1, 1), (0, 2)), (1, 1))
    return ((q, w.wt, zp, sw, bias, [3, 3], [2, 2], [1, 1, 0, 2], [1, 1], -128, True, dtype),
            k8.int8_conv_plain(q, w.wt, zp, sw, bias, (3, 3), *geo, -128, True, dtype))


def flash_case(rng, dtype):
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, n, 32)).astype(np.float32)).to(dtype)
               for n in (9, 13, 13))
    return (q, k, v, 0.3), reference_attention(q, k, v, 0.3)


def bottleneck_case(rng, dtype):
    x = torch.from_numpy(np.abs(rng.normal(size=(1, 8, 8, 64))).astype(np.float32)).to(dtype)
    w = {k: torch.from_numpy(rng.normal(0, 0.1, size=s).astype(np.float32))
         for k, s in (("w1", (64, 64)), ("b1", (64,)), ("w2", (3, 3, 64, 64)), ("b2", (64,)),
                      ("w3", (64, 256)), ("b3", (256,)), ("wd", (64, 256)), ("bd", (256,)))}
    return (x, *fr.pack_bottleneck(dtype, **w)), fr.bottleneck_plain(x, **w)


def stem_case(rng, dtype):
    x = torch.from_numpy(rng.normal(size=(1, 16, 24, 12)).astype(np.float32)).to(dtype)
    p = fr.pack_stem(dtype, torch.from_numpy(rng.normal(0, 0.1, size=(4, 4, 12, 64)).astype(
        np.float32)), torch.from_numpy(rng.normal(0, 0.1, size=(64,)).astype(np.float32)))
    return (x, p.w4, p.bias, p.frag), fr.stem_plain(x, p.w4, p.bias)


OPS = {"flash_attention": flash_case, "fused_bottleneck": bottleneck_case,
       "fused_stem": stem_case, "int8_conv": int8_conv_case}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_cpu_is_plain_and_fake_gives_its_shape(name, dtype):
    args, plain = OPS[name](np.random.default_rng(7), dtype)
    op = getattr(torch.ops.fod, name)
    out = op(*args)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (out.shape, out.dtype, out.stride())
