"""K9, the int8 activation quantizer (future_od_tpu_torch/ops/int8_quantize.py),
on the CPU: its plain range and quantization (what the op runs on CPU
tensors) against the torch chain ops/quant.py ran before K9 and against the
JAX package's codes, bit for bit.

- The JAX codes are the operand that `future_od_tpu/ops/quant.py`'s cores
  hand to `lax.conv_general_dilated` (caught by a spy on it, eagerly): the
  port's codes are the operand its cores hand to K8 (`int8_conv_codes`).
- Planted edge cases: exact .5 ties after the second division (round half
  to even), quotients whose first division rounds onto or off a tie, values
  at and past the clamp limits, dead channels (m = 1), bf16 input, an empty
  tensor (range 0, as `initial=0.0`), and a block's conv1 and downsample
  sharing one range pass.
- The shapes are tests/test_torch_quant.py's; the spy stands in for XLA's
  convolution, so no JAX convolution compiles and no JAX ResNet-50 is
  built here. About 20 s alone (most of it importing JAX and the port).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.ops import quant as jq
from future_od_tpu_torch.models.resnet import Bottleneck
from future_od_tpu_torch.ops import int8_quantize as k9
from future_od_tpu_torch.ops import quant as pq
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_quant import DTYPES, SHAPES, bits, conv_case, geometry


def old_chain(x, kernel, nonneg):
    """The codes and scale of the dynamic path as ops/quant.py computed them
    before K9 (unfused torch, in the JAX op order)."""
    x32 = x.float()
    act = pq._amax(x32.abs(), range(x.ndim - 1))
    w_amax = pq._kernel_in_amax(kernel)
    m = pq._sqrt(torch.clamp_min(act, 1e-12) / torch.clamp_min(w_amax, 1e-12))
    m = torch.where(act > 0.0, m, torch.ones_like(m))
    x32 = x32 / m
    if nonneg:
        scale = torch.clamp_min(pq._amax(x32), 1e-12) / 255.0
        return (torch.clamp(torch.round(x32 / scale), 0.0, 255.0) - 128.0).to(torch.int8), scale
    scale = torch.clamp_min(pq._amax(x32.abs()), 1e-12) / pq.QMAX
    return torch.clamp(torch.round(x32 / scale), -pq.QMAX, pq.QMAX).to(torch.int8), scale


def port_codes(monkeypatch, fn, *args, **kw):
    """The codes and the scale products `fn` (an ops/quant.py conv) hands to K8
    (the spy stands in for K8: its output is not needed here)."""
    seen = []
    run = pq.int8_conv_codes

    def spy(q, w, zp, sw, *rest):
        seen.append((q, sw))
        return q.new_empty(0)
    monkeypatch.setattr(pq, "int8_conv_codes", spy)
    fn(*args, **kw)
    monkeypatch.setattr(pq, "int8_conv_codes", run)
    return seen[0]


def jax_codes(monkeypatch, fn, *args, padding=((0, 0), (0, 0)), **kw):
    """The codes `fn` (a future_od_tpu/ops/quant.py function) hands to XLA's
    convolution, its zero-point padding cut off. The spy returns zeros of the
    convolution's shape (`jax.eval_shape`), so no convolution compiles."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def spy(lhs, *rest, **kws):
        seen.append(np.asarray(lhs))
        out = jax.eval_shape(lambda: conv(lhs, *rest, **kws))
        return jnp.zeros(out.shape, out.dtype)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    fn(*args, padding=padding, **kw)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)
    q = seen[0]
    (pt, pb), (pl, pr) = padding
    if fn in (jq.int8_conv_nonneg, jq.int8_conv_nonneg_static, jq._conv_nonneg_core):
        q = q[:, pt:q.shape[1] - pb, pl:q.shape[2] - pr]  # padded with -128 beforehand
    return q


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_dynamic_codes_equal_old_chain_and_jax(monkeypatch, name, dtype):
    """The dynamic path's codes (K9's range, `static_smooth_and_scale`, K9's
    quantization) equal the pre-K9 torch chain's and JAX's, bit for bit, and
    its scale the old one."""
    tdt, jdt = DTYPES[dtype]
    x, k, b = conv_case(name, seed=5)
    nonneg = SHAPES[name][-1]
    geo = geometry(name)
    tx, tk = torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt)
    port_fn, jax_fn = ((pq.int8_conv_nonneg, jq.int8_conv_nonneg) if nonneg
                       else (pq.int8_conv, jq.int8_conv))
    q, _ = port_codes(monkeypatch, port_fn, tx, tk, torch.from_numpy(b), **geo)
    old_q, _ = old_chain(tx, tk, nonneg)
    assert q.dtype == torch.int8 and torch.equal(q, old_q)
    ref = jax_codes(monkeypatch, jax_fn, jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt),
                    jnp.asarray(b), **geo)
    np.testing.assert_array_equal(q.numpy(), ref)


def planted(nonneg: bool):
    """x (1, 4, 4, 4), m and scale with planted ties and clamp values: per
    channel m in {1, 2, 0.5, 3}, scale 0.25, so that x / m / scale hits
    k + 0.5 exactly (both rounding directions), the clamp limits and past
    them, and, for m = 3, quotients that land a tie only after the first
    division rounds."""
    scale = np.float32(0.25)
    m = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    t = np.array([0.5, 1.5, 2.5, 3.5, 126.5, 127.0, 127.5, 128.0, 253.5, 254.5, 255.0, 255.5,
                  256.0, 1000.0, 0.0, 7.25], np.float32)
    if not nonneg:
        t = np.concatenate([t[:8], -t[:8]])
    x = (t[:, None] * scale * m[None, :]).astype(np.float32)  # (16, 4): t * scale * m
    x[-1, 3] = np.nextafter(np.float32(5.5 * 0.25 * 3.0), np.float32(0))  # just below a tie
    return x.reshape(1, 4, 4, 4), m, scale


@pytest.mark.parametrize("nonneg", [True, False])
def test_quantize_ties_and_clamps(monkeypatch, nonneg):
    """K9's plain quantization on planted ties and clamp limits equals JAX's
    core's codes (x / m in JAX, then its core): at least 16 quotients are
    exact ties."""
    x, m, scale = planted(nonneg)
    jx32 = jnp.asarray(x) / jnp.asarray(m)
    core = jq._conv_nonneg_core if nonneg else jq._conv_signed_core
    wq = jnp.ones((1, 1, 4, 8), jnp.int8)
    ref = jax_codes(monkeypatch, core, jx32, jnp.float32(scale), wq, jnp.ones(8, jnp.float32),
                    None, (1, 1), padding=((0, 0), (0, 0)), dilation=(1, 1),
                    out_dtype=jnp.float32)
    tx, tm, ts = torch.from_numpy(x), torch.from_numpy(m), torch.tensor(scale)
    q = k9.quantize_codes_plain(tx, tm, ts, nonneg)
    np.testing.assert_array_equal(q.numpy(), ref)
    assert torch.equal(k9.quantize_codes(tx, tm, ts, nonneg), q)  # the op on CPU tensors
    lo, hi = (-128, 127) if nonneg else (-127, 127)
    assert int(q.min()) == lo and int(q.max()) == hi
    ties = (tx / tm / ts).flatten()
    assert int(((ties - ties.floor()) == 0.5).sum()) >= 16


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_range_equals_jax(dtype):
    """K9's plain range (|x| and x, a dead channel) equals JAX's
    observe_channel_amax and smooth_factors' act range; bf16 in, f32 out."""
    tdt, jdt = DTYPES[dtype]
    x, k, _ = conv_case("3x3 64-64", seed=7)
    x[..., 5] = -np.abs(x[..., 5])  # a channel whose signed max is 0
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    for absolute in (True, False):
        r = k9.channel_range_plain(tx, absolute)
        assert r.dtype == torch.float32 and torch.equal(k9.channel_range(tx, absolute), r)
        np.testing.assert_array_equal(bits(r), bits(jq.observe_channel_amax(jx, not absolute)))
    np.testing.assert_array_equal(bits(pq.smooth_factors(tx, torch.from_numpy(k).to(tdt))),
                                  bits(jq.smooth_factors(jx, jnp.asarray(k).astype(jdt))))
    assert float(k9.channel_range_plain(tx)[0]) == 0.0  # conv_case's dead channel


def test_empty_and_per_tensor():
    """An empty tensor: range 0 (JAX's initial=0.0), no codes; the per-tensor
    quantization (a range over one channel) equals JAX's."""
    empty = torch.zeros((0, 4, 4, 6))
    assert torch.equal(k9.channel_range(empty), torch.zeros(6))
    np.testing.assert_array_equal(k9.channel_range(empty).numpy(),
                                  np.asarray(jq.observe_channel_amax(jnp.zeros((0, 4, 4, 6)),
                                                                     False)))
    q = k9.quantize_codes(empty, torch.ones(6), torch.tensor(1.0), True)
    assert q.shape == empty.shape and q.dtype == torch.int8
    x, _, _ = conv_case("stem 7x7/2", seed=8)
    tq, ts = pq.quantize_act_per_tensor(torch.from_numpy(x))
    jqv, js = jq.quantize_act_per_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(bits(ts), bits(js))


def test_block_shares_one_range(monkeypatch):
    """A downsample block on the dynamic path takes three range passes (x for
    conv1 and the downsample, then conv2's and conv3's inputs), and a
    convolution given its input's range equals the one that takes its own,
    bit for bit."""
    torch.manual_seed(0)
    block = Bottleneck(64, 32, stride=2, downsample=True, int8=True).eval()
    for bn in (block.bn1, block.bn2, block.bn3, block.downsample[1]):
        bn.running_var.uniform_(0.5, 2.0)
        bn.running_mean.normal_()
    x = torch.relu(torch.randn(1, 64, 12, 10)).contiguous(memory_format=torch.channels_last)
    calls = []
    run = pq.channel_range

    def counted(t, *a, **kw):
        calls.append(tuple(t.shape))
        return run(t, *a, **kw)
    monkeypatch.setattr(pq, "channel_range", counted)
    with torch.no_grad():
        out = block(x)
    assert out.shape == (1, 128, 6, 5)
    assert calls == [(1, 12, 10, 64), (1, 12, 10, 32), (1, 6, 5, 32)]
    x_nhwc = x.permute(0, 2, 3, 1)
    with torch.no_grad():
        for conv, bn in ((block.conv1, block.bn1), block.downsample):
            scale, shift = bn.scale_shift()
            kernel = conv.weight.permute(2, 3, 1, 0) * scale
            geo = {"strides": conv.stride}
            alone = pq.int8_conv_nonneg(x_nhwc, kernel, shift, **geo)
            given = pq.int8_conv_nonneg(x_nhwc, kernel, shift, x_range=run(x_nhwc), **geo)
            assert torch.equal(alone, given)


def test_ops_fake_and_refusals():
    """The ops' fake implementations give the real outputs' shapes and
    dtypes; off the CPU the operands are checked first (a meta tensor
    raises)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.zeros((2, 5, 7, 12), dtype=torch.bfloat16))
        r = k9._RANGE_OP(x, True)
        q = k9._QUANTIZE_OP(x, mode.from_tensor(torch.ones(12)), mode.from_tensor(
            torch.tensor(0.5)), False)
    assert tuple(r.shape) == (12,) and r.dtype == torch.float32
    assert tuple(q.shape) == (2, 5, 7, 12) and q.dtype == torch.int8
    meta = torch.zeros((2, 5, 7, 12), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k9.channel_range(meta)
    with pytest.raises(ValueError, match="m must be"):
        k9.quantize_codes(meta, torch.ones(5, device="meta"), torch.tensor(1.0, device="meta"),
                          True)


def test_study_tools_match_the_sources():
    """The int8 split marks every function it names in this tree, and each of
    K8's ablations finds the text it removes in csrc/int8_conv.cu."""
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.tools import int8_split, k8_ablation

    assert len(int8_split.mark_owners()) == len(int8_split.INT8_SPLIT_MARKS)
    source = (_kernels.CSRC_DIR / "int8_conv.cu").read_text()
    for name, edits in k8_ablation.ABLATIONS.items():
        assert all(old in source for old, _ in edits), name
