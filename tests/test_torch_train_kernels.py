"""The port's training flash attention (plain K4-K7) against the JAX package.

On the CPU, `flash_attention_train` runs the plain versions of the forward,
dq and dk/dv kernels and of the dropout mask; they are held against the
Pallas kernels in interpret mode (values and gradients, as
tests/test_flash_attention.py holds those kernels against XLA) and against
the JAX mask itself, bit for bit, on numpy-seeded inputs.
tests/test_torch_kernels_cuda.py holds the CUDA kernels against these plain
versions on a card.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from future_od_tpu.ops.flash_attention import _dropout_mask as jax_dropout_mask
from future_od_tpu.ops.flash_attention import flash_attention_train as jax_flash_attention_train

from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops import flash_attention as fa

# f32 on both sides, as a fraction of the reference's max |value|. The
# forward differs by reassociated sums and the order of the online softmax's
# rescales (measured 6.9e-7 over the cases below); the gradients add the
# recomputed probabilities and sums over up to 384 keys (measured 1.2e-6),
# so the gradient tolerance is set at 1e-5, tighter than 1e-4.
OUT_TOL = 1e-5
GRAD_TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


class TestDropoutMask:
    @pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 2])
    @pytest.mark.parametrize("rate", [0.1, 0.3])
    @pytest.mark.parametrize(
        "bh,row0,col0,nq_pad,nk_pad",
        [(0, 0, 0, 512, 350), (5, 256, 128, 512, 384), (31, 64, 0, 128, 350),
         # flat index past 2^31 and 2^32: the wrapping uint32 arithmetic
         (40000, 256, 128, 512, 350), (65535, 128, 300, 512, 350)],
    )
    def test_bits_equal_jax(self, seed, rate, bh, row0, col0, nq_pad, nk_pad):
        shape = (64, 50)
        ref = jax_dropout_mask(
            jnp.asarray([seed], jnp.int32), jnp.int32(bh), row0, col0, shape, rate,
            nq_pad, nk_pad,
        )
        row = row0 + torch.arange(shape[0])[:, None]
        col = col0 + torch.arange(shape[1])[None, :]
        out = fa.dropout_keep_mask(seed, bh, row, col, rate, nq_pad, nk_pad)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        kept = float((out > 0).float().mean())
        assert abs(kept - (1 - rate)) < 0.05

    @pytest.mark.parametrize("H_local,H,h0", [(4, 8, 0), (4, 8, 4), (2, 8, 6), (1, 3, 2)])
    def test_head_share_is_the_global_slice(self, H_local, H, h0):
        """A call over heads h0..h0+H_local of H (tensor parallelism) draws
        the head slice of the all-heads call's mask, and the hash at each
        global batch·head is JAX's _dropout_mask there."""
        B, Nq, Nk, nq_pad, nk_pad, seed, rate = 3, 20, 30, 256, 512, 77, 0.1
        full = fa._mask(seed, B * H, Nq, Nk, rate, nq_pad, nk_pad, "cpu").reshape(B, H, Nq, Nk)
        share = fa._mask(seed, B * H_local, Nq, Nk, rate, nq_pad, nk_pad, "cpu",
                         (H_local, H, h0)).reshape(B, H_local, Nq, Nk)
        assert torch.equal(share, full[:, h0:h0 + H_local])
        for bh in (0, B * H_local - 1):
            g = fa.global_heads(bh, (H_local, H, h0))
            assert g == (bh // H_local) * H + h0 + bh % H_local
            ref = jax_dropout_mask(jnp.asarray([seed], jnp.int32), jnp.int32(g), 0, 0, (Nq, Nk),
                                   rate, nq_pad, nk_pad)
            np.testing.assert_array_equal(share.reshape(-1, Nq, Nk)[bh].numpy(), np.asarray(ref))

    def test_geometry_is_the_jax_blocks(self):
        # the stage-1 train shapes at 350 tokens: encoder and decoder
        assert fa.train_shapes(350, 350, 256, 512) == (512, 350)
        assert fa.train_shapes(128, 350, 256, 512) == (128, 350)
        assert fa.train_shapes(100, 130, 64, 128) == (128, 256)


def random_inputs(seed, B, H, Nq, Nk, d, dv):
    rng = np.random.default_rng(seed)
    q, k, do = (rng.normal(size=s).astype(np.float32) for s in
                ((B, H, Nq, d), (B, H, Nk, d), (B, H, Nq, dv)))
    v = rng.normal(size=(B, H, Nk, dv)).astype(np.float32)
    return q, k, v, do


class TestFlashTrainPlain:
    @pytest.mark.parametrize("blocks", [(64, 128), (256, 512)])
    @pytest.mark.parametrize("rate", [0.0, 0.3])
    @pytest.mark.parametrize("shape", [(2, 2, 100, 130, 32, 32), (1, 2, 128, 384, 64, 32)])
    def test_matches_pallas_interpret(self, shape, rate, blocks):
        B, H, Nq, Nk, d, dv = shape
        q, k, v, do = random_inputs(7, *shape)
        seed, scale = 1234, 1.0 / math.sqrt(d)

        def jax_fn(q, k, v):
            return jax_flash_attention_train(
                q, k, v, jnp.int32(seed), scale, rate, *blocks, True
            )

        ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = vjp(jnp.asarray(do))

        qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
        out = fa.flash_attention_train(qt, kt, vt, seed, scale, rate, *blocks)
        out.backward(t(do))
        np.testing.assert_allclose(
            out.detach().numpy(), np.asarray(ref), atol=OUT_TOL * np.abs(ref).max(), rtol=0
        )
        for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), ref_grads):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=f"d{name}"
            )

    def test_dropout_changes_with_the_seed(self):
        q, k, v, _ = random_inputs(3, 1, 2, 40, 260, 32, 32)
        outs = [fa.flash_attention_train(t(q), t(k), t(v), s, 0.2, 0.3) for s in (5, 5, 6)]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        assert not torch.allclose(outs[0], outs[2])


class TestPlainBackward:
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("shape", [(3, 70, 90, 32, 32), (2, 33, 300, 64, 32)])
    def test_plain_dq_dkv_equal_autograd(self, shape, rate):
        """Plain K5/K6 are the gradient of plain K4 (autograd through it)."""
        BH, Nq, Nk, d, dv = shape
        q, k, v, do = (t(x) for x in random_inputs(11, 1, BH, Nq, Nk, d, dv))
        q, k, v, do = q[0], k[0], v[0], do[0]
        seed, scale = 99, 1.0 / math.sqrt(d)
        nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
        qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
        out, lse = fa.flash_train_fwd_plain(qa, ka, va, seed, scale, rate, nq_pad, nk_pad)
        out.backward(do)
        delta = (do * out.detach()).sum(-1)
        args = (seed, scale, rate, nq_pad, nk_pad)
        dq = fa.flash_dq_plain(q, k, v, do, lse.detach(), delta, *args)
        dk, dv_ = fa.flash_dkv_plain(q, k, v, do, lse.detach(), delta, *args)
        for got, want in ((dq, qa.grad), (dk, ka.grad), (dv_, va.grad)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


class TestWrappers:
    def test_cpu_takes_plain_versions_and_counts_nothing(self):
        q, k, v, do = (t(x)[0] for x in random_inputs(2, 1, 2, 20, 30, 32, 32))
        before = dict(_kernels.launch_counts)
        args = (3, 0.2, 0.1, 256, 256)
        out, lse = fa.flash_train_fwd(q, k, v, *args)
        ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
        delta = (do * out).sum(-1)
        torch.testing.assert_close(fa.flash_dq(q, k, v, do, lse, delta, *args),
                                   fa.flash_dq_plain(q, k, v, do, lse, delta, *args),
                                   rtol=0, atol=0)
        fa.flash_dkv(q, k, v, do, lse, delta, *args)
        assert _kernels.launch_counts == before

    def test_never_falls_back_off_cpu(self):
        q = torch.empty((2, 8, 32), device="meta")
        row = torch.empty((2, 8), device="meta")
        args = (0, 1.0, 0.1, 8, 8)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_train_fwd(q, q, q, *args)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_dq(q, q, q, q, row, row, *args)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_dkv(q, q, q, q, row, row, *args)
        # head dims 8 are padded onto a built pair; above 256 none is built
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_train_fwd(q[..., :8], q[..., :8], q[..., :8], *args)
        wide = torch.empty((2, 8, 264), device="meta")
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_train_fwd(wide, wide, wide, *args)

    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_transposed_views_equal_contiguous(self, rate):
        """attend_heads passes (B, N, H, d) storage as (B, H, N, d) views,
        which the kernels read in place: the same values and gradients as
        the contiguous copies."""
        B, H, Nq, Nk, d, dv = 2, 4, 33, 130, 32, 32
        rng = np.random.default_rng(5)
        qh, kh, vh, doh = (t(rng.normal(size=(B, n, H, w)).astype(np.float32))
                           for n, w in ((Nq, d), (Nk, d), (Nk, dv), (Nq, dv)))
        results = []
        for views in (True, False):
            q, k, v = (x.transpose(1, 2) if views else x.transpose(1, 2).contiguous()
                       for x in (qh, kh, vh))
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = fa.flash_attention_train(q, k, v, 11, d**-0.5, rate)
            out.backward(doh.transpose(1, 2))
            results.append((out, q.grad, k.grad, v.grad))
        for got, want in zip(*results):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())

    @pytest.mark.parametrize("h0", [0, 2])
    def test_head_share_equals_the_full_call(self, h0):
        """K4-K6's plain versions over heads h0..h0+2 of 4 (`heads`), as a
        tensor-parallel rank calls them: the output and the gradients are
        the all-heads call's slice, the dropout mask included."""
        B, H, Hl, Nq, Nk, d = 2, 4, 2, 17, 40, 32
        rng = np.random.default_rng(9)
        q, k, v, do = (t(rng.normal(size=(B, H, n, d)).astype(np.float32))
                       for n in (Nq, Nk, Nk, Nq))
        results = []
        for heads, part in ((None, slice(None)), ((Hl, H, h0), slice(h0, h0 + Hl))):
            x = [a[:, part].clone().requires_grad_(True) for a in (q, k, v)]
            out = fa.flash_attention_train(*x, 11, d**-0.5, 0.3, heads=heads)
            out.backward(do[:, part])
            results.append([out] + [a.grad for a in x])
        for got, want in zip(results[1], results[0]):
            want = want[:, h0:h0 + Hl]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())
        with pytest.raises(ValueError, match="holds 2 heads"):
            fa.flash_attention_train(q[:, :2], k[:, :2], v[:, :2], 1, 1.0, 0.1, heads=(2, 4, 3))

    def test_kernel_argument_layout(self):
        """The packed TrainArgs is csrc/flash_attention_train.cu's struct
        whole (offsetof nk_pad == 312, the head share after it, sizeof 328,
        so the by-value copy reads no byte past the buffer), and the outputs
        of a (B, H, N, d) operand are laid out (B, N, H, w), as attend_heads
        reshapes them without a copy; a (BH, N, d) operand's are contiguous."""
        assert fa._TRAIN_ARGS.size == 328
        x = torch.empty((2, 4, 10, 32)).transpose(1, 2).transpose(1, 2)
        out = fa._empty_rows(x, 7, 16, torch.bfloat16)
        assert out.shape == (2, 4, 7, 16) and out.dtype == torch.bfloat16
        assert out.transpose(1, 2).is_contiguous()
        assert fa._empty_rows(torch.empty(8, 10, 32), 7, 16, torch.float32).is_contiguous()
        # a (BH, N, w) operand is one batch of BH heads: (pointer, 0, head
        # and row strides), as (B, H, N, w) and (B, H, N) ones give theirs
        three = torch.empty(8, 10, 32)
        assert fa._dims(three) == (1, 8, 10, 32) and fa._dims(x) == (2, 4, 10, 32)
        assert fa._fields(three, 4) == (three.data_ptr(), 0, 320, 32)
        assert fa._fields(out, 4) == (out.data_ptr(), 7 * 4 * 16, 16, 4 * 16)
        rows = torch.empty(8, 10)
        assert fa._fields(rows, 3) == (rows.data_ptr(), 0, 10, 1)

    def test_train_attention_cost(self):
        cost = fa.train_attention_cost(64, 350, 350, 32, 32, 4)
        assert cost["flash_train_fwd"][0] == 2 * 64 * 350 * 350 * 64
        assert cost["flash_train_dq"][0] == 2 * 64 * 350 * 350 * 96
        assert cost["flash_train_dkv"][0] == 2 * 64 * 350 * 350 * 128
        assert all(nbytes > 0 for _, nbytes in cost.values())
