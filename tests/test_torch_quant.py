"""The int8 PTQ backbone of the port (future_od_tpu_torch/ops/quant.py, K8's
plain version in ops/int8_conv.py, the int8 arms of models/resnet.py) against
the JAX package's (future_od_tpu/ops/quant.py, models/resnet.py), on the CPU.

- Every quant function against the JAX function, bit for bit: the block
  shapes 1x1 64->64, 3x3 64->64, 3x3/2 128->128, 3x3 dilation 2 512->512,
  1x1 256->1024, the 7x7/2 stem over 3 channels and the s2d 4x4 stem with
  padding (2, 1), f32 and bf16 inputs (the quantization computes in f32, so
  bf16 rounds once at the end on both sides). Equality holds because the
  port takes the smoothing factors' square root in float64 (torch's f32
  sqrt on the CPU is not correctly rounded) and K8's plain version sums the
  codes exactly in float64, as XLA's int32 convolution does.
- K8's plain version against JAX's `_conv_nonneg_core` / `_conv_signed_core`
  on the same codes, bit for bit; the op's fake implementation; the bytes
  its bound counts.
- The int8 `CDetrBackbone` (hidden 32, two 64x96 images, random weights
  and frozen BN from numpy, each BN variance + eps a power of 4): the
  trunk's output bit for bit against JAX's, dynamic, calibrating (the
  ranges too) and static; the 1x1 projection after it is a float
  convolution summed in another order, so the whole backbone is held to
  1e-6 of its max (measured 4.1e-7). The variances are chosen so that the
  BN scale's rsqrt is exact: XLA's CPU rsqrt and torch's (1/sqrtf) differ
  by 1 ulp on 35 % of inputs (1e6 uniform in [0.5, 1.5]), a scale 1 ulp off
  moves a smoothing factor or a weight code, and the flip spreads through
  the trunk. With fully random variances the trunk is held to 5 % in norm
  (measured 1.8 %; JAX's own jitted int8 trunk is 3.2 % from its eager
  one).
- The counterparts of tests/test_quant.py's TestInt8Backbone and
  TestInt8Static, the JAX "quant" collection through the weight bridge, the
  gates' precedence (K8's calls a forward), bf16 with the ranges cast to
  bf16 (bit for bit), static int8 under the fused gates (the range buffers
  those of the tree JAX's init makes there, calibrated and served), and a
  tiny int8 flagship (dynamic and static) through `make_inference_fn`
  against JAX's.

The JAX side runs eagerly (op by op: a jitted JAX int8 trunk rounds
otherwise) on `jax.eval_shape` trees filled by numpy; its int8 ops compile
once for the file (the backbone's two images are the tiny flagship's two
past frames, so both reuse them): about 40 s of the file's 115 s alone;
the bf16 trunk about 10 s more, the tiny flagship's transformer about 12,
the JAX fused kernels in interpret mode about 7.
"""
import functools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from future_od_tpu.models import resnet as jax_resnet
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.resnet import CDetrBackbone as JaxBackbone
from future_od_tpu.ops import fused_resnet as jax_fused
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.ops import quant as jq
from future_od_tpu.train.step import make_inference_fn as jax_make_inference_fn

from future_od_tpu_torch.models import resnet as port_resnet
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.resnet import CDetrBackbone, int8_calibration
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.ops import int8_conv as k8
from future_od_tpu_torch.ops import quant as pq
from future_od_tpu_torch.train.step import calibrate_int8, make_inference_fn
from future_od_tpu_torch.utils import jax_weights
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_variants import random_variables

# (B, H, W, Cin, KH, KW, Cout, stride, padding, dilation, post-ReLU input);
# where the backbone below (2 x 64x96) has the shape, the same, so the JAX
# side compiles its ops once
SHAPES = {
    "1x1 64-64": (2, 16, 24, 64, 1, 1, 64, 1, ((0, 0), (0, 0)), 1, True),
    "3x3 64-64": (2, 16, 24, 64, 3, 3, 64, 1, ((1, 1), (1, 1)), 1, True),
    "3x3/2 128-128": (2, 16, 24, 128, 3, 3, 128, 2, ((1, 1), (1, 1)), 1, True),
    "3x3 d2 512-512": (1, 8, 9, 512, 3, 3, 512, 1, ((2, 2), (2, 2)), 2, True),
    "1x1 256-1024": (2, 4, 6, 256, 1, 1, 1024, 1, ((0, 0), (0, 0)), 1, True),
    "stem 7x7/2": (2, 64, 96, 3, 7, 7, 64, 2, ((3, 3), (3, 3)), 1, False),
    "s2d stem 4x4": (1, 16, 24, 12, 4, 4, 64, 1, ((2, 1), (2, 1)), 1, False),
}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# The whole backbone (trunk bit-equal, then a float 1x1 conv 2048 -> 32 summed
# in another order): max |port - JAX| over max |JAX|, measured 4.1e-7.
PROJ_RTOL = 1e-6
# The trunk with BN variances whose rsqrt rounds otherwise in XLA and torch:
# |port - JAX| over |JAX| in norm, measured 1.8e-2.
RANDOM_BN_RTOL = 5e-2
# The static trunk under the fused gates, whose fused blocks' f32 sums round
# otherwise in the Pallas kernel and in K2's plain version, so that codes
# flip downstream: |port - JAX| over |JAX| in norm, measured 2.6e-2.
FUSED_RTOL = 5e-2
FUSED_GATES = {"FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}
BN_EPS = np.float32(1e-5)
# The tiny flagship through make_inference_fn: tests/test_torch_flagship.py's
# bounds for scores (sigmoids) and boxes (pixels of a 96-wide image).
SCORE_ATOL, BOX_ATOL = 1e-5, 2e-3
TINY = dict(num_classes=4, hidden_dim=32, enc_nheads=4, nheads=4, enc_layers=1,
            dec_layers=1, dim_feedforward=48, num_queries=5, dropout=0.0)
IMU = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
# K8's calls in a forward of one frame: the stem, 16 blocks x 3, 4 downsamples;
# 33 under the fused gates (K2 takes layer1's and layer2's stride-1 blocks,
# K3 the stem)
TRUNK_CONVS, FUSED_TRUNK_CONVS = 53, 33


def conv_case(name, seed=0):
    """x (NHWC; post-ReLU with channels of spread scales where the conv is
    a block's), the kernel (HWIO) and bias, as numpy f32."""
    B, H, W, C, KH, KW, Co, *_, nonneg = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    if nonneg:
        x = (np.maximum(x, 0) * rng.uniform(0.1, 3.0, C)).astype(np.float32)
        x[..., 0] = 0.0  # a dead channel keeps m = 1
    k = (rng.normal(size=(KH, KW, C, Co)) * 0.1).astype(np.float32)
    b = rng.normal(size=Co).astype(np.float32)
    return x, k, b


def geometry(name):
    *_, s, p, d, _ = SHAPES[name]
    return dict(strides=(s, s), padding=p, dilation=(d, d))


def bits(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_conv_functions_equal_jax(name, dtype):
    """int8_conv_nonneg / int8_conv and their static forms (ranges = the
    input's true channel ranges) equal the JAX functions bit for bit."""
    tdt, jdt = DTYPES[dtype]
    x, k, b = conv_case(name)
    nonneg = SHAPES[name][-1]
    jx, jk = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    tx, tk = torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt)
    amax = np.abs(x).max(axis=(0, 1, 2)).astype(np.float32)
    geo = geometry(name)
    dyn = (jq.int8_conv_nonneg, pq.int8_conv_nonneg) if nonneg else (jq.int8_conv, pq.int8_conv)
    static = ((jq.int8_conv_nonneg_static, pq.int8_conv_nonneg_static) if nonneg
              else (jq.int8_conv_static, pq.int8_conv_static))
    ref = dyn[0](jx, jk, jnp.asarray(b), **geo)
    out = dyn[1](tx, tk, torch.from_numpy(b), **geo)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(bits(out), bits(ref))
    ref = static[0](jx, jk, jnp.asarray(amax), jnp.asarray(b), **geo)
    out = static[1](tx, tk, torch.from_numpy(amax), torch.from_numpy(b), **geo)
    np.testing.assert_array_equal(bits(out), bits(ref))
    # relu in K8's epilogue equals relu after the call
    fused = dyn[1](tx, tk, torch.from_numpy(b), relu=True, **geo)
    assert torch.equal(fused, torch.relu(dyn[1](tx, tk, torch.from_numpy(b), **geo)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_primitives_equal_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, k, _ = conv_case("3x3 64-64", seed=1)
    jx, jk = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    tx, tk = torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt)
    np.testing.assert_array_equal(bits(pq.smooth_factors(tx, tk)), bits(jq.smooth_factors(jx, jk)))
    for (tq, ts), (jqv, js) in ((pq.quantize_weight_per_channel(tk), jq.quantize_weight_per_channel(jk)),
                               (pq.quantize_act_per_tensor(tx), jq.quantize_act_per_tensor(jx))):
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(bits(ts), bits(js))
    for nonneg in (True, False):
        np.testing.assert_array_equal(bits(pq.observe_channel_amax(tx, nonneg)),
                                      bits(jq.observe_channel_amax(jx, nonneg)))
    amax = np.abs(x).max(axis=(0, 1, 2))
    ta, ja = torch.from_numpy(amax).to(tdt), jnp.asarray(amax).astype(jdt)  # ranges cast too
    (tm, tr), (jm, jr) = pq.static_smooth_and_scale(ta, tk), jq.static_smooth_and_scale(ja, jk)
    np.testing.assert_array_equal(bits(tm), bits(jm))
    np.testing.assert_array_equal(bits(tr), bits(jr))
    for value in (0.0, 3.7):
        np.testing.assert_array_equal(
            bits(pq._static_scale(torch.tensor(value), 255.0)),
            bits(jq._static_scale(jnp.float32(value), 255.0)))
    zeros = torch.zeros((1, 4, 4, 4), dtype=tdt)
    np.testing.assert_array_equal(pq.smooth_factors(zeros, tk[:, :, :4]).numpy(), np.ones(4))


@pytest.mark.parametrize("name", ["3x3/2 128-128", "stem 7x7/2"])
def test_k8_plain_equals_jax_core(name):
    """K8's plain version (reached through the port's core, the op on CPU
    tensors) against JAX's core on the same smoothed input, scale, codes and
    bias; and called directly on the codes."""
    x, k, b = conv_case(name, seed=2)
    nonneg = SHAPES[name][-1]
    wq, ws = jq.quantize_weight_per_channel(jnp.asarray(k))
    scale = jnp.float32(np.abs(x).max() / (255.0 if nonneg else 127.0))
    geo = geometry(name)
    args = (geo["strides"], geo["padding"], geo["dilation"])
    jcore, pcore = ((jq._conv_nonneg_core, pq._conv_nonneg_core) if nonneg
                    else (jq._conv_signed_core, pq._conv_signed_core))
    ref = jcore(jnp.asarray(x), scale, wq, ws, jnp.asarray(b), *args, jnp.float32)
    twq, tws = torch.from_numpy(np.asarray(wq)), torch.from_numpy(np.asarray(ws))
    out = pcore(torch.from_numpy(x), torch.tensor(np.asarray(scale)), twq, tws,
                torch.from_numpy(b), *args, torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the same codes straight into int8_conv_plain
    q = torch.from_numpy(x) / torch.tensor(np.asarray(scale))
    q = (torch.clamp(torch.round(q), 0, 255) - 128 if nonneg
         else torch.clamp(torch.round(q), -127, 127)).to(torch.int8)
    zp = k8.zero_point_correction(twq) if nonneg else None
    direct = k8.int8_conv_plain(q, k8.pack_int8_weights(twq).wt, zp,
                                torch.tensor(np.asarray(scale)) * tws, torch.from_numpy(b),
                                k.shape[:2], *args, -128 if nonneg else 0, False, torch.float32)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(ref))


def test_k8_op_fake_and_refusals():
    """The op's fake implementation gives the output's shape and dtype; the
    packed weights pad K to the mma's k-step; off the CPU the op's operands
    are checked first (a meta tensor raises)."""
    B, H, W, C, KH, KW, Co, s, p, d, _ = SHAPES["stem 7x7/2"]
    wq = torch.randint(-127, 128, (KH, KW, C, Co), dtype=torch.int8)
    w = k8.pack_int8_weights(wq)
    assert tuple(w.wt.shape) == (Co, 160) and not w.wt[:, 147:].any()
    sw = torch.rand(Co)
    with FakeTensorMode() as mode:
        q = mode.from_tensor(torch.zeros((B, H, W, C), dtype=torch.int8))
        out = k8._INT8_CONV(q, mode.from_tensor(w.wt), None, mode.from_tensor(sw), None,
                            [KH, KW], [s, s], [3, 3, 3, 3], [d, d], 0, True, torch.bfloat16)
    assert tuple(out.shape) == (B, H // 2, W // 2, Co) and out.dtype == torch.bfloat16
    meta = torch.zeros((B, H, W, C), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k8.int8_conv_codes(meta, k8.Int8ConvWeights(w.wt.to("meta"), (KH, KW)), None,
                           sw.to("meta"), None, (s, s), p, (d, d), 0, False, torch.float32)
    with pytest.raises(ValueError, match="multiple of 64"):
        k8._check(meta, w.wt[:48].to("meta"), None, sw[:48].to("meta"), None, torch.float32)


@pytest.mark.parametrize("H,W,C,k,s,p,d,read", [
    (8, 8, 256, 1, 2, 0, 1, 16),  # a 1x1/2 downsample reads every second row and column
    (8, 8, 256, 3, 2, 1, 1, 64),
    (8, 9, 512, 3, 1, 2, 2, 72),
    (64, 96, 3, 7, 2, 3, 1, 64 * 96),
])
def test_k8_cost_counts_the_codes_read(H, W, C, k, s, p, d, read):
    """K8's least bytes count the input pixels some window reads (`read`),
    each once, beside the weights, the per-channel vectors and the output."""
    geo = ((k, k), (s, s), ((p, p), (p, p)), (d, d))
    ops, nbytes = k8.int8_conv_cost(2, H, W, C, 64, *geo, 4)
    Ho, Wo = k8.output_hw(H, W, *geo)
    assert ops == 2 * 2 * Ho * Wo * 64 * k * k * C
    assert nbytes == 2 * read * C + k * k * C * 64 + 12 * 64 + 4 * 2 * Ho * Wo * 64


# --- the int8 backbone ----------------------------------------------------


def port_backbone(variables, **kw):
    """A port CDetrBackbone (hidden 32) holding a JAX CDetrBackbone's
    variables (params, frozen and, when given, quant)."""
    v = jax_weights._Leaves(variables)
    sd = {}
    jax_weights._resnet_body(sd, "body", v, "body")
    jax_weights._conv(sd, "input_proj", v, "params/input_proj")
    assert not v.left()
    model = CDetrBackbone(32, **kw).eval()
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.array(a, np.float32)) for k, a in sd.items()}, strict=False)
    assert not unexpected and all(k.endswith("_amax") for k in missing)
    assert not missing or "quant" not in variables
    return model


def exact_rsqrt_bn(frozen, seed):
    """The frozen tree with every running_var replaced by 0.25, 1 or 4 less
    eps, so var + eps is a power of 4 and its rsqrt exact on both sides."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "running_var" not in jax.tree_util.keystr(path):
            return leaf
        powers = rng.choice(np.array([0.25, 1.0, 4.0], np.float32), size=leaf.shape)
        return (powers - BN_EPS).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, frozen)


def jax_body(state):
    return np.asarray(state["intermediates"]["body"]["__call__"][0])


def port_body(model, x):
    return model.body(x).permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def backbone_case():
    """(x, variables with quant zeroed, JAX dynamic (out, body), the JAX
    calibrated quant collection, JAX static (out, body), the frozen tree as
    drawn, before `exact_rsqrt_bn`). The calibration is the JAX
    mutable-"quant" apply (the dynamic path, observed)."""
    x = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = JaxBackbone(hidden_dim=32, int8=True, int8_static=True)
    variables = random_variables(jax.eval_shape(lambda: jm.init(jax.random.key(0), x)), seed=5)
    variables["quant"] = jax.tree.map(np.zeros_like, variables["quant"])
    random_frozen = variables["frozen"]
    variables["frozen"] = exact_rsqrt_bn(random_frozen, seed=8)
    out_d, state = jm.apply(variables, x, mutable=["quant", "intermediates"],
                            capture_intermediates=True)
    quant = jax.tree.map(np.asarray, state["quant"])
    out_s, st_s = jm.apply(dict(variables, quant=quant), x, mutable=["intermediates"],
                           capture_intermediates=True)
    return (x, variables, (np.asarray(out_d), jax_body(state)), quant,
            (np.asarray(out_s), jax_body(st_s)), random_frozen)


@pytest.fixture
def fused_gates(monkeypatch):
    """FUTURE_OD_FUSED_RESNET=1 FUTURE_OD_FUSED_STEM=1 for both packages.
    The JAX gate admits TPU backends only, so here it is opened and the
    JAX fused kernels run in interpret mode, as the JAX package's own tests
    run them on the CPU."""
    for key, value in FUSED_GATES.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jax_resnet, "fused_resnet_allowed", lambda: True)
    for name in ("fused_bottleneck", "fused_stem"):
        monkeypatch.setattr(jax_fused, name,
                            functools.partial(getattr(jax_fused, name), interpret=True))


def assert_backbone(out, body, ref):
    np.testing.assert_array_equal(body.numpy(), ref[1])
    rel = np.abs(out.numpy() - ref[0]).max() / np.abs(ref[0]).max()
    assert rel <= PROJ_RTOL, rel


def flat_ranges(quant):
    """The JAX quant collection as {port buffer name: array}."""
    out = {}
    for key, value in quant["body"].items():
        if key.endswith("_amax"):
            out[f"body.{key}"] = value
        else:
            stage, block = key[len("layer"):].split("_block")
            for conv, amax in value.items():
                out[f"body.layer{stage}.{block}.{conv}"] = amax
    return out


class TestBackboneAgainstJax:
    def test_random_bn_variances(self, backbone_case):
        """Fully random BN variances (random_variables' draw): the trunk
        within RANDOM_BN_RTOL of JAX's in norm (see the module docstring)."""
        x, variables, *_, random_frozen = backbone_case
        variables = {"params": variables["params"], "frozen": random_frozen}
        _, state = JaxBackbone(hidden_dim=32, int8=True).apply(
            variables, x, mutable=["intermediates"], capture_intermediates=True)
        ref = jax_body(state)
        with torch.no_grad():
            body = port_body(port_backbone(variables, int8=True), torch.from_numpy(x)).numpy()
        assert np.linalg.norm(body - ref) / np.linalg.norm(ref) < RANDOM_BN_RTOL

    def test_dynamic(self, backbone_case):
        x, variables, ref_d, *_ = backbone_case
        model = port_backbone({k: variables[k] for k in ("params", "frozen")}, int8=True)
        tx = torch.from_numpy(x)
        with torch.no_grad():
            assert_backbone(model(tx), port_body(model, tx), ref_d)

    def test_calibration_then_static(self, backbone_case):
        """The calibration pass gives JAX's dynamic output and JAX's ranges
        bit for bit; the static forward then gives JAX's static output."""
        x, variables, ref_d, quant, ref_s, _ = backbone_case
        model = port_backbone({k: variables[k] for k in ("params", "frozen")}, int8=True,
                              int8_static=True)
        tx = torch.from_numpy(x)
        with torch.no_grad(), int8_calibration(model):
            out, body = model(tx), None
        ranges = {k: b for k, b in model.named_buffers() if k.endswith("_amax")}
        want = flat_ranges(quant)
        assert sorted(ranges) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(ranges[key].numpy(), value, err_msg=key)
        with torch.no_grad(), int8_calibration(model):
            body = port_body(model, tx)
        assert_backbone(out, body, ref_d)
        with torch.no_grad():
            assert_backbone(model(tx), port_body(model, tx), ref_s)

    def test_bridged_ranges(self, backbone_case):
        """The JAX quant collection loads into the buffers (the bridge), and
        the static forward equals JAX's."""
        x, variables, _, quant, ref_s, _ = backbone_case
        model = port_backbone(dict(variables, quant=quant), int8=True, int8_static=True)
        tx = torch.from_numpy(x)
        with torch.no_grad():
            assert_backbone(model(tx), port_body(model, tx), ref_s)

    def test_bf16_with_ranges_cast(self, backbone_case):
        """bf16 as bench.py serves it: every f32 leaf cast to bf16, the
        ranges included, through the static trunk: JAX's bf16 trunk bit for
        bit."""
        x, variables, _, quant, *_ = backbone_case
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), dict(variables, quant=quant))
        _, st = JaxBackbone(hidden_dim=32, int8=True, int8_static=True).apply(
            cast, jnp.asarray(x, jnp.bfloat16), mutable=["intermediates"],
            capture_intermediates=True)
        model = port_backbone(dict(variables, quant=quant), int8=True,
                              int8_static=True).to(torch.bfloat16)
        assert model.body.conv1_amax.dtype == torch.bfloat16
        with torch.no_grad():
            got = port_body(model, torch.from_numpy(x).bfloat16()).float().numpy()
        np.testing.assert_array_equal(got, jax_body(st).astype(np.float32))

    def test_static_under_fused_gates(self, backbone_case, fused_gates):
        """Under the fused gates the fused K2 blocks and K3 stem run before
        int8, so only the 33 convolutions int8 reaches have ranges, as in
        the tree JAX's init makes under them; the bridge fills them from
        JAX's calibration; a port calibration passes `assert_calibrated`
        and its static trunk is JAX's within FUSED_RTOL in norm (the fused
        blocks round otherwise, see FUSED_RTOL)."""
        x, variables, *_ = backbone_case
        jm = JaxBackbone(hidden_dim=32, int8=True, int8_static=True)
        jvars = {k: variables[k] for k in ("params", "frozen")}
        # the mutable apply creates the ranges (zeros, as init does) and calibrates them
        _, state = jm.apply(jvars, x, mutable=["quant"])
        quant = jax.tree.map(np.asarray, state["quant"])
        _, st_s = jm.apply(dict(jvars, quant=quant), x, mutable=["intermediates"],
                           capture_intermediates=True)
        ref = jax_body(st_s)
        bridged = port_backbone(dict(jvars, quant=quant), int8=True, int8_static=True)
        ranges = sorted(k for k, _ in bridged.named_buffers() if k.endswith("_amax"))
        assert ranges == sorted(flat_ranges(quant)) and len(ranges) == FUSED_TRUNK_CONVS
        model = port_backbone(jvars, int8=True, int8_static=True)
        with pytest.raises(ValueError, match="uncalibrated"):
            pq.assert_calibrated(model)
        tx = torch.from_numpy(x)
        with torch.no_grad(), int8_calibration(model):
            model(tx)
        pq.assert_calibrated(model)
        with torch.no_grad():
            for m in (model, bridged):
                body = port_body(m, tx).numpy()
                assert np.linalg.norm(body - ref) / np.linalg.norm(ref) < FUSED_RTOL


# --- counterparts of tests/test_quant.py::TestInt8Backbone / TestInt8Static


def jittered_backbone(**kw):
    """A port CDetrBackbone (hidden 32) from seed 0 with its frozen BN
    statistics perturbed, so the fold into the kernels is exercised."""
    model = CDetrBackbone(32, **kw)
    g = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            port_resnet.init_conv_(m, g)
        if isinstance(m, port_resnet.FrozenBatchNorm2d):
            n = m.weight.numel()
            m.running_mean += 0.05 * torch.arange(n) / n
            m.running_var += 0.05 * torch.arange(n) / n
    return model.eval()


def toy(seed=0, shape=(1, 64, 96, 3), scale=1.0):
    return scale * torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(
        np.float32))


def twin(source, **kw):
    model = CDetrBackbone(32, **kw).eval()
    model.load_state_dict(source.state_dict(), strict=False)
    return model


class TestInt8Backbone:
    def test_same_tree_as_float(self):
        """The dynamic model's state is the float model's; the static one
        adds a range buffer an int8 convolution, named as the JAX quant
        collection's leaves."""
        keys = set(CDetrBackbone(32).state_dict())
        assert set(CDetrBackbone(32, int8=True).state_dict()) == keys
        extra = set(CDetrBackbone(32, int8=True, int8_static=True).state_dict()) - keys
        assert len(extra) == TRUNK_CONVS and all(k.endswith("_amax") for k in extra)
        assert "body.conv1_amax" in extra and "body.layer4.0.downsample_conv_amax" in extra

    def test_int8_close_to_float(self):
        f = jittered_backbone()
        q = twin(f, int8=True)
        x = toy()
        with torch.no_grad():
            out_f, out_q = f(x), q(x)
        rel = (torch.linalg.norm(out_q - out_f) / torch.linalg.norm(out_f)).item()
        assert rel < 0.12, rel
        cos = (torch.sum(out_f * out_q) / (torch.linalg.norm(out_f)
                                            * torch.linalg.norm(out_q))).item()
        assert cos > 0.99, cos

    def test_training_path_is_float(self):
        f = jittered_backbone().train()
        q = twin(f, int8=True, int8_static=True).train()
        x = toy(shape=(1, 32, 32, 3))
        with torch.no_grad():
            assert torch.equal(f(x), q(x))


class TestInt8Static:
    def test_static_equals_dynamic_on_calibration_batch(self):
        d = twin(jittered_backbone(), int8=True)
        s = twin(d, int8=True, int8_static=True)
        x = toy()
        with torch.no_grad():
            with int8_calibration(s):
                calib = s(x)
            out_d, out_s = d(x), s(x)
        assert torch.equal(calib, out_d) and torch.equal(out_s, out_d)

    def test_calibration_is_running_max(self):
        s = twin(jittered_backbone(), int8=True, int8_static=True)
        d = twin(s, int8=True)
        x1, x2 = toy(shape=(1, 32, 32, 3)), toy(1, (1, 32, 32, 3), 3.0)
        with torch.no_grad(), int8_calibration(s):
            s(x1)
            before = {k: b.clone() for k, b in s.named_buffers() if k.endswith("_amax")}
            out = s(x2)
        with torch.no_grad():
            assert torch.equal(out, d(x2))  # a calibration pass is the dynamic path
        after = dict(s.named_buffers())
        for key, b in before.items():
            assert bool((after[key] >= b).all()), key
        stem = after["body.conv1_amax"]
        assert bool((stem > before["body.conv1_amax"]).any())

    def test_static_close_to_float_off_calibration(self):
        f = jittered_backbone()
        s = twin(f, int8=True, int8_static=True)
        x_cal, x = toy(1, scale=1.5), toy(2)
        with torch.no_grad():
            with int8_calibration(s):
                s(x_cal)
            out_f, out_s = f(x), s(x)
        rel = (torch.linalg.norm(out_s - out_f) / torch.linalg.norm(out_f)).item()
        assert rel < 0.15, rel

    def test_uncalibrated_ranges_degrade_not_saturate(self):
        rng = np.random.default_rng(4)
        x = torch.from_numpy(np.abs(rng.normal(size=(1, 8, 8, 4))).astype(np.float32))
        k = torch.from_numpy(rng.normal(size=(3, 3, 4, 64)).astype(np.float32))
        out = pq.int8_conv_nonneg_static(x, k, torch.zeros(4))
        ref = pq.int8_conv_nonneg(x, k)
        assert bool(torch.isfinite(out).all())
        assert (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item() < 1.0

    def test_assert_calibrated(self):
        s = twin(jittered_backbone(), int8=True, int8_static=True)
        with pytest.raises(ValueError, match="uncalibrated"):
            pq.assert_calibrated(s)
        with torch.no_grad(), int8_calibration(s):
            s(toy(shape=(1, 32, 32, 3)))
        pq.assert_calibrated(s)
        pq.assert_calibrated(CDetrBackbone(32))  # no ranges: nothing to check
        with pytest.raises(ValueError, match="uncalibrated"):
            pq.assert_calibrated({"a_amax": torch.zeros(3)})


def count_k8(monkeypatch):
    calls = []
    original = pq.int8_conv_codes

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(pq, "int8_conv_codes", counted)
    return calls


@pytest.mark.parametrize("gates,want", [
    ({}, TRUNK_CONVS),
    ({"FUTURE_OD_INT8_SKIP": "stem"}, TRUNK_CONVS - 1),
    ({"FUTURE_OD_INT8_SKIP": "1,4"}, TRUNK_CONVS - 10 - 10),
    ({"FUTURE_OD_S2D_STEM": "1"}, TRUNK_CONVS - 1),
    ({"FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}, 33),
])
def test_gates_precede_int8(monkeypatch, gates, want):
    """The fused K2 blocks and the fused K3 stem come before int8,
    FUTURE_OD_S2D_STEM=1 keeps the stem float, FUTURE_OD_INT8_SKIP keeps the
    named parts float: K8's calls in one forward (53, 33 fused)."""
    for key, value in gates.items():
        monkeypatch.setenv(key, value)
    calls = count_k8(monkeypatch)
    model = CDetrBackbone(32, int8=True).eval()
    with torch.no_grad():
        model(toy())
    assert len(calls) == want


# --- the tiny flagship -----------------------------------------------------


@pytest.fixture(scope="module")
def flagship_case():
    """(batch, JAX variables with calibrated quant, JAX dynamic output, JAX
    static output) for the tiny int8 flagship on one clip of 3 frames at
    64x96 (the heads' last layers random, so outputs depend on the image)."""
    rng = np.random.default_rng(6)
    batch = {k: rng.normal(size=(1, 3, w)).astype(np.float32) for k, w in IMU.items()}
    batch["video"] = rng.normal(size=(1, 3, 64, 96, 3)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_build_flagship(JaxArgs(**TINY, int8_static=True))
    variables = random_variables(jax.eval_shape(lambda: jm.init(jax.random.key(0), jbatch)),
                                 seed=7)
    variables["quant"] = jax.tree.map(np.zeros_like, variables["quant"])
    variables["frozen"] = exact_rsqrt_bn(variables["frozen"], seed=9)
    _, state = jm.apply(variables, jbatch, mutable=["quant"])
    variables["quant"] = jax.tree.map(np.asarray, state["quant"])
    jd = jax_build_flagship(JaxArgs(**TINY, int8_backbone=True))
    ref_d = jax_make_inference_fn(jd)({k: variables[k] for k in ("params", "frozen")}, jbatch)
    ref_s = jax_make_inference_fn(jm)(variables, jbatch)
    return batch, variables, jax.tree.map(np.asarray, ref_d), jax.tree.map(np.asarray, ref_s)


def assert_outputs(out, ref):
    assert out["boxes"].shape == ref["boxes"].shape
    np.testing.assert_allclose(out["class_scores"].numpy(), ref["class_scores"], rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], rtol=0, atol=BOX_ATOL)


class TestFlagship:
    def test_dynamic(self, flagship_case):
        batch, variables, ref_d, _ = flagship_case
        model = build_flagship(SpatioTemporalDETRArgs(**TINY, int8_backbone=True), device="cpu")
        jax_weights.load_jax_variables(model, {k: variables[k] for k in ("params", "frozen")})
        assert_outputs(make_inference_fn(model, device="cpu")(batch), ref_d)

    def test_static_bridged_and_calibrated(self, flagship_case):
        """The bridged JAX ranges serve JAX's static output; a port model
        calibrated on the batch gets the same ranges bit for bit; the bridge
        refuses ranges the model has no buffers for."""
        batch, variables, _, ref_s = flagship_case
        args = SpatioTemporalDETRArgs(**TINY, int8_static=True)
        model = jax_weights.load_jax_variables(build_flagship(args, device="cpu"), variables)
        assert_outputs(make_inference_fn(model, device="cpu")(batch), ref_s)
        fresh = build_flagship(args, device="cpu")
        sd = {k: v for k, v in model.state_dict().items() if not k.endswith("_amax")}
        fresh.load_state_dict(sd, strict=False)
        with pytest.raises(ValueError, match="uncalibrated"):
            make_inference_fn(fresh, device="cpu")
        calibrate_int8(fresh, [batch], device="cpu")
        for key, value in model.state_dict().items():
            if key.endswith("_amax"):
                assert torch.equal(fresh.state_dict()[key], value), key
        dynamic = build_flagship(SpatioTemporalDETRArgs(**TINY, int8_backbone=True),
                                 device="cpu")
        with pytest.raises(ValueError, match="lacks"):
            jax_weights.load_jax_variables(dynamic, variables)

    def test_static_under_fused_gates_serves(self, flagship_case, monkeypatch):
        """Built under the fused gates, the static flagship has ranges for
        the 33 convolutions int8 reaches; refused uncalibrated, it serves
        once calibrated, with the dynamic path's output on its calibration
        batch."""
        for key, value in FUSED_GATES.items():
            monkeypatch.setenv(key, value)
        batch, variables, *_ = flagship_case
        dynamic = build_flagship(SpatioTemporalDETRArgs(**TINY, int8_backbone=True),
                                 device="cpu")
        jax_weights.load_jax_variables(dynamic, {k: variables[k] for k in ("params", "frozen")})
        static = build_flagship(SpatioTemporalDETRArgs(**TINY, int8_static=True), device="cpu")
        missing, unexpected = static.load_state_dict(dynamic.state_dict(), strict=False)
        assert not unexpected and len(missing) == FUSED_TRUNK_CONVS
        assert all(k.endswith("_amax") for k in missing)
        with pytest.raises(ValueError, match="uncalibrated"):
            make_inference_fn(static, device="cpu")
        calibrate_int8(static, [batch], device="cpu")
        got = make_inference_fn(static, device="cpu")(batch)
        want = make_inference_fn(dynamic, device="cpu")(batch)
        for key in ("class_scores", "boxes"):
            assert torch.equal(got[key], want[key]), key
