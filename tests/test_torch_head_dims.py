"""K1 and K4-K6 at head dims no kernel is built for: the wrappers' padding
route against the JAX package's Pallas kernels in interpret mode.

On the card a call at (d, dv) that is not one of SUPPORTED_HEAD_DIMS runs on
the smallest built pair (D, DV) that holds it (`kernel_head_dims`): q and k
zero-padded along d, v and do along dv (`pad_head_dim`), the outputs sliced
back, the scale the caller's 1/sqrt(d). The CUDA kernels cannot run here, but
the route can: this file pads, runs the kernels' plain versions at (D, DV)
and slices, through the wrappers' own helpers, and holds the result to JAX's
`flash_attention` and to `flash_attention_train` with `jax.grad`, which take
any head dims, at (24, 40), (128, 64), (96, 128), the widest built pairs
(256, 128) and (256, 256), and (200, 136), padded onto (256, 256): 2 heads of 40 queries
against 72 keys, dropout 0.1 in training (the mask hashes (batch·head, row,
column), never d, so padding leaves it alone). Tolerance: 2e-6 of the
reference's largest |value|, f32 on both sides (sums reassociated, the
padded columns' exact zeros among them; measured up to 1.2e-6).
tests/test_torch_kernels_cuda.py holds the CUDA kernels at these and other
padded pairs against the plain versions on a card.

About 16 s alone (`JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_head_dims.py -q`).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from future_od_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from future_od_tpu.ops.flash_attention import flash_attention_train as jax_flash_attention_train

from future_od_tpu_torch.ops import flash_attention as fa
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-6
PAIRS = [(24, 40), (128, 64), (96, 128), (256, 128), (256, 256), (200, 136)]
B, H, NQ, NK = 1, 2, 40, 72
SEED, RATE = 777, 0.1


def inputs(d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, NQ, d), (B, H, NK, d), (B, H, NK, dv), (B, H, NQ, dv))]


def within(out, ref):
    ref = np.asarray(ref, np.float64)
    gap = np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max()
    assert gap <= TOL, gap


def test_routes():
    """Each pair runs on the pair the wrappers pad it to."""
    assert [fa.kernel_head_dims(d, dv) for d, dv in PAIRS] == [
        (64, 64), (128, 64), (128, 128), (256, 128), (256, 256), (256, 256)]


@pytest.mark.parametrize("d,dv", PAIRS)
def test_inference_route_equals_jax(d, dv):
    """K1's route: pad, `reference_attention` (the op's plain version), slice."""
    q, k, v, _ = inputs(d, dv)
    D, DV = fa.kernel_head_dims(d, dv)
    scale = 1.0 / math.sqrt(d)
    qp, kp = (fa.pad_head_dim(torch.from_numpy(a), D) for a in (q, k))
    vp = fa.pad_head_dim(torch.from_numpy(v), DV)
    out = fa.reference_attention(qp, kp, vp, scale)[..., :dv]
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True)
    assert out.shape == (B, H, NQ, dv)
    within(out.numpy(), ref)


@pytest.mark.parametrize("d,dv", PAIRS)
def test_training_route_equals_jax(d, dv):
    """K4-K6's route: the forward and the three gradients of the padded
    operands through the plain K4, K5 and K6, sliced, against JAX's
    forward and jax.grad of <out, do>."""
    q, k, v, do = inputs(d, dv)
    D, DV = fa.kernel_head_dims(d, dv)
    scale = 1.0 / math.sqrt(d)
    nq_pad, nk_pad = fa.train_shapes(NQ, NK, 256, 512)
    args = (SEED, scale, RATE, nq_pad, nk_pad)
    qp, kp = (fa.pad_head_dim(torch.from_numpy(a), D) for a in (q, k))
    vp, dop = (fa.pad_head_dim(torch.from_numpy(a), DV) for a in (v, do))
    out, lse = fa.flash_train_fwd_plain(qp, kp, vp, *args)
    out = out[..., :dv]
    delta = (torch.from_numpy(do) * out).sum(-1)  # as FlashAttentionTrain.backward
    dq = fa.flash_dq_plain(qp, kp, vp, dop, lse, delta, *args)[..., :d]
    dk, dvv = fa.flash_dkv_plain(qp, kp, vp, dop, lse, delta, *args)
    dk, dvv = dk[..., :d], dvv[..., :dv]

    def loss(q_, k_, v_):
        o = jax_flash_attention_train(q_, k_, v_, jnp.int32(SEED), scale, RATE, 256, 512, True)
        return jnp.sum(o * jnp.asarray(do)), o

    # jitted: a third of the eager interpreter's time
    (_, ref_out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    within(out.numpy(), ref_out)
    for got, want in zip((dq, dk, dvv), grads):
        assert got.shape == want.shape
        within(got.numpy(), want)
