"""The mask losses in the port against the JAX package on the CPU:
`ops/losses.py::dice_loss`, `models/set_criterion.py::_mask_losses` (the
mask focal and dice losses of the matched predictions, resized to the
targets' size as `jax.image.resize(method="linear")` resizes: antialiased
when an axis shrinks) and the criterion with `masks=True` end to end,
values and gradients, with rtol 1e-5; the resize itself against JAX's in
both directions; and the batch check of `compute_loss`. About 25 s alone
(JAX eager and a few jits of the criterion).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.models import set_criterion as jax_sc
from future_od_tpu.models.st_detr import compute_loss as jax_compute_loss
from future_od_tpu.ops import losses as jax_losses

from future_od_tpu_torch.models import set_criterion as sc
from future_od_tpu_torch.models.st_detr import compute_loss
from future_od_tpu_torch.ops import losses

RTOL = 1e-5
ATOL = 1e-7  # on losses near 0 (a gradient element of unmatched queries is 0)

# (pred h, w) -> (target H, W): up, down, and one axis each way
RESIZES = {"up": ((6, 8), (24, 32)), "down": ((24, 20), (8, 6)), "mixed": ((5, 16), (15, 12)),
           "same": ((7, 9), (7, 9)), "odd up": ((3, 5), (8, 11)), "odd down": ((13, 11), (4, 5))}


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_equals_jax(case):
    (h, w), (H, W) = RESIZES[case]
    x = np.random.default_rng(0).normal(size=(2, 3, h, w)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, H, W), method="linear")
    out = sc.resize_linear(t(x), (H, W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)


def test_downsizing_is_not_bilinear_interpolation():
    """Why the resize is not F.interpolate: shrinking, JAX averages over the
    widened triangle, where bilinear interpolation reads two pixels."""
    x = np.random.default_rng(1).normal(size=(1, 1, 24, 20)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 8, 6), method="linear"))
    bilinear = torch.nn.functional.interpolate(t(x), (8, 6), mode="bilinear",
                                               align_corners=False).numpy()
    assert np.abs(bilinear - ref).max() > 0.1
    up = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 48, 40), method="linear"))
    np.testing.assert_allclose(torch.nn.functional.interpolate(
        t(x), (48, 40), mode="bilinear", align_corners=False).numpy(), up, rtol=RTOL, atol=1e-6)


def test_dice_loss_and_grad_equal_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (5, 48)).astype(np.float32)
    targets = (rng.uniform(size=(5, 48)) < 0.4).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(jax_losses.dice_loss)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.float32(3.0))
    x = t(logits).requires_grad_(True)
    out = losses.dice_loss(x, t(targets), torch.tensor(3.0))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=RTOL, atol=1e-9)


def mask_problem(seed, hw, HW, B=2, M=7, N=6):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 2, (B, M) + hw).astype(np.float32)
    masks = (rng.uniform(size=(B, N) + HW) < 0.3).astype(np.float32)
    active = rng.uniform(size=(B, N)) < 0.7
    active[0, :2] = True
    pred_idx = np.stack([rng.permutation(M)[:N] for _ in range(B)]).astype(np.int64)
    pred_idx[1, 0] = M  # an active slot left unmatched
    return pred, masks, active, pred_idx


@pytest.mark.parametrize("case", ["up", "down", "mixed", "same"])
def test_mask_losses_and_grads_equal_jax(case):
    hw, HW = RESIZES[case]
    pred, masks, active, pred_idx = mask_problem(3, hw, HW)
    jcfg = jax_sc.CriterionConfig(num_classes=2, masks=True)
    cfg = sc.CriterionConfig(num_classes=2, masks=True)
    num_boxes = float(active.sum())

    def jax_total(p):
        out = jax_sc._mask_losses({"pred_masks": p}, {"masks": jnp.asarray(masks),
                                                      "active": jnp.asarray(active)},
                                  jnp.asarray(pred_idx.astype(np.int32)), num_boxes, jcfg)
        return out["loss_mask"] + 3.0 * out["loss_dice"], out

    (_, ref), ref_grad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(pred))
    x = t(pred).requires_grad_(True)
    out = sc._mask_losses({"pred_masks": x}, {"masks": t(masks), "active": t(active)},
                          t(pred_idx), torch.tensor(num_boxes), cfg)
    (out["loss_mask"] + 3.0 * out["loss_dice"]).backward()
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].item(), float(ref[key]), rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=RTOL, atol=1e-9)


def criterion_problem(seed, hw, HW, B=2, M=8, N=10, C=3):
    rng = np.random.default_rng(seed)
    active = np.zeros((B, N), bool)
    active[0, [1, 4, 7]] = True
    active[1, [0, 2, 3, 9]] = True
    targets = {"boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                                        rng.uniform(0.05, 0.3, (B, N, 2))], -1).astype(np.float32),
               "labels": rng.integers(0, C, (B, N)).astype(np.int32), "active": active,
               "masks": (rng.uniform(size=(B, N) + HW) < 0.3).astype(np.float32)}

    def level(masks):
        out = {"pred_logits": rng.normal(0, 1, (B, M, C)).astype(np.float32),
               "pred_boxes": rng.uniform(0.2, 0.8, (B, M, 4)).astype(np.float32)}
        if masks:
            out["pred_masks"] = rng.normal(0, 2, (B, M) + hw).astype(np.float32)
        return out

    outputs = level(True)
    outputs["aux_outputs"] = [level(False)]
    return outputs, targets, C


@pytest.mark.parametrize("case", ["up", "down"])
@pytest.mark.parametrize("cost_slots", [128, 5])  # 5: the masks go through the compaction
def test_criterion_with_masks_equals_jax(case, cost_slots):
    hw, HW = RESIZES[case]
    outputs, targets, C = criterion_problem(4, hw, HW)
    kw = dict(num_classes=C, masks=True, cost_slots=cost_slots, mask_loss_coef=1.5,
              dice_loss_coef=0.5)
    jcfg, cfg = jax_sc.CriterionConfig(**kw), sc.CriterionConfig(**kw)

    def jax_total(out):
        found = jax_sc.set_criterion(out, {k: jnp.asarray(v) for k, v in targets.items()}, jcfg)
        return jax_sc.weighted_total(found, jcfg, 1)[0], found

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jax.tree.map(jnp.asarray, outputs))
    tout = jax.tree.map(lambda a: t(a).requires_grad_(True), outputs)
    found = sc.set_criterion(tout, {k: t(v) for k, v in targets.items()}, cfg)
    total, weights = sc.weighted_total(found, cfg, 1)
    total.backward()
    assert weights["loss_mask"] == 1.5 and weights["loss_dice"] == 0.5
    assert {"loss_mask", "loss_dice"} <= set(found) and set(found) == set(jlosses)
    for key, value in jlosses.items():
        np.testing.assert_allclose(found[key].item(), float(value), rtol=RTOL, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=RTOL)
    np.testing.assert_allclose(tout["pred_masks"].grad.numpy(), np.asarray(jgrads["pred_masks"]),
                               rtol=RTOL, atol=1e-9)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(tout[key].grad.numpy(), np.asarray(jgrads[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_compute_loss_needs_the_batch_masks():
    """masks=True without data["masks"] raises the JAX package's ValueError."""
    outputs, targets, C = criterion_problem(5, (6, 8), (24, 32))
    data = {"video": np.zeros((2, 1, 24, 32, 3), np.float32),
            "active": targets["active"], "classes": targets["labels"],
            "boxes": np.tile(np.asarray([2.0, 3.0, 10.0, 12.0], np.float32), (2, 10, 1))}
    jcfg = jax_sc.CriterionConfig(num_classes=C, masks=True)
    cfg = sc.CriterionConfig(num_classes=C, masks=True)
    with pytest.raises(ValueError, match="requires dense mask targets"):
        jax_compute_loss(jax.tree.map(jnp.asarray, outputs),
                         {k: jnp.asarray(v) for k, v in data.items()}, jcfg)
    with pytest.raises(ValueError, match="requires dense mask targets"):
        compute_loss(jax.tree.map(t, outputs), {k: t(v) for k, v in data.items()}, cfg)
    data["masks"] = targets["masks"]
    ref = jax_compute_loss(jax.tree.map(jnp.asarray, outputs),
                           {k: jnp.asarray(v) for k, v in data.items()}, jcfg)
    out = compute_loss(jax.tree.map(t, outputs), {k: t(v) for k, v in data.items()}, cfg)
    np.testing.assert_allclose(out[0].item(), float(ref[0]), rtol=RTOL)
