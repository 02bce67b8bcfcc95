"""One training step of the sequential joint-encoder variant in the port
against the JAX package on the CPU: the loss, its stats and every
parameter's gradient, through the prevout and frame-memory attentions (one
set of encoder weights applied a frame), with the matcher's indices injected
into both sides (as tests/test_torch_train.py's criterion test does) and
dropout 0. The port routes its training attention through the train flash
kernels' plain versions (FUTURE_OD_TRAIN_FLASH=1, TRAIN_FLASH_MIN_KEYS
lowered to this size's 8 tokens). Then one `make_train_step` step of the
variant moves every tensor with a gradient (the prevout and frame-memory
attentions' all) and no frozen one, with a finite loss.

The tiny model and batch are tests/test_torch_variants.py's. About 25 s
alone (one JAX compile of the loss's gradient).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.models import build as jax_build
from future_od_tpu.models.st_detr import compute_loss as jax_compute_loss
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs

from future_od_tpu_torch.models import build
from future_od_tpu_torch.models import layers as port_layers
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.train import optimizer as opt
from future_od_tpu_torch.train.step import forward_and_loss, make_train_step
from future_od_tpu_torch.utils.jax_weights import state_arrays
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import GRAD_FLOOR
from test_torch_variants import TINY, jax_variables, jnp_batch, load_jax_variables, make_batch

N_TARGETS = 6
# per tensor, max |grad difference| over max(max |grad|, GRAD_FLOOR x the
# model's largest), by part: 10x the gaps measured on the CPU (4.8e-6 in the
# separate encoder, 8.8e-7 in the joint encoder, 5.6e-5 in the detector)
GRAD_TOL = {"separate_encoder": 5e-5, "joint_encoder": 1e-5, "detector": 6e-4}
LOSS_RTOL = 1e-5


def with_targets(batch, seed=1):
    rng = np.random.default_rng(seed)
    B = batch["video"].shape[0]
    wh = np.abs(rng.normal(size=(B, N_TARGETS, 4))).astype(np.float32) * 20
    active = np.zeros((B, N_TARGETS), np.int64)
    active[0, [0, 2, 3]] = 1
    active[1, [1, 5]] = 1
    return {**batch, "boxes": np.concatenate([wh[..., :2], wh[..., :2] + wh[..., 2:]], -1),
            "classes": rng.integers(0, TINY["num_classes"], (B, N_TARGETS)), "active": active}


def injected_indices(batch, levels, queries, seed=2):
    """(levels, B, N) query indices for the active targets, `queries` (no
    match) elsewhere."""
    rng = np.random.default_rng(seed)
    idx = np.full((levels,) + batch["active"].shape, queries, np.int64)
    for a in range(levels):
        for b, row in enumerate(batch["active"]):
            slots = np.nonzero(row)[0]
            idx[a, b, slots] = rng.choice(queries, size=len(slots), replace=False)
    return idx


@pytest.fixture(scope="module")
def case():
    """(port sequential variant with the JAX weights, JAX model, JAX
    variables, batch with targets, injected indices)."""
    batch = with_targets(make_batch(3))
    jmodel = jax_build.build_with_joint_encoder(JaxArgs(**TINY), "sequential")
    variables = jax_variables(jmodel, batch, seed=3)
    port = build.build_with_joint_encoder(SpatioTemporalDETRArgs(**TINY), "sequential",
                                          device="cpu")
    idx = injected_indices(batch, TINY["dec_layers"], TINY["num_queries"])
    return load_jax_variables(port, variables), jmodel, variables, batch, idx


def test_sequential_train_gradients_equal_jax(case, monkeypatch):
    port, jmodel, variables, batch, idx = case
    cfg = JaxArgs(**TINY).criterion_config()
    jdata, jidx = jnp_batch(batch), jnp.asarray(idx.astype(np.int32))

    def jax_loss(params):
        out = jmodel.apply({"params": params, "frozen": variables["frozen"]}, jdata,
                           deterministic=False)
        return jax_compute_loss(out, jdata, cfg, jidx)

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    want = state_arrays({"params": jax.tree.map(np.asarray, jgrads),
                         "frozen": variables["frozen"]})

    monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
    monkeypatch.setattr(port_layers, "TRAIN_FLASH_MIN_KEYS", 1)
    calls = []
    original = port_layers.flash_attention_train
    monkeypatch.setattr(port_layers, "flash_attention_train",
                        lambda *a, **k: calls.append(a[0].shape[2]) or original(*a, **k))
    port.train()
    port.zero_grad(set_to_none=True)
    loss, (stats, _, _) = forward_and_loss(
        port, SpatioTemporalDETRArgs(**TINY).criterion_config(),
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(idx))
    loss.backward()
    port.eval()
    # queries a call: the per-frame encoder's layer (the 2 past frames
    # folded) and the sequential encoder's 2 layers (frame 0: self; frame 1:
    # self, prevout, frame memory) over 8 tokens; the decoder's 2 layers x
    # 2 image attentions over 5 queries
    assert sorted(calls) == [5] * 4 + [8] * (1 + 2 * 4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for key in ("labels", "box_l1", "box_giou"):
        np.testing.assert_allclose(stats[key].item(), float(jstats[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters() if p.grad is not None}
    assert any(".prevout_attn." in n for n in grads)
    assert any(".previmage_attn.0." in n for n in grads)
    floor = GRAD_FLOOR * max(np.abs(want[n]).max() for n in grads)
    for name, g in grads.items():
        part = name.split(".")[1]
        tol = GRAD_TOL[part] * max(np.abs(want[name]).max(), floor)
        np.testing.assert_allclose(g, want[name], rtol=0, atol=tol, err_msg=name)
    frozen = [n for n, p in port.named_parameters() if not p.requires_grad]
    assert frozen and all(not np.any(want[n]) for n in frozen)


def test_sequential_train_step_moves_the_trained_tensors(case):
    port, _, _, batch, _ = case
    args = SpatioTemporalDETRArgs(**TINY)
    model = build.build_with_joint_encoder(args, "sequential", device="cpu")
    model.load_state_dict(port.state_dict())
    optimizer = opt.build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                    args.max_norm, args.freeze_stem)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, stats, _, output = make_train_step(model, args.criterion_config(), optimizer,
                                             device="cpu")(batch, 0)
    assert np.isfinite(loss.item()) and float(stats["nonfinite_skipped"]) == 0.0
    assert output["boxes"].shape == (2, 1, 1, TINY["num_queries"], 4)
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        # a gradient that is zero but for rounding (the egodeep attention's
        # q over one key) moves a tensor by less than an f32 ulp
        if p.grad is not None and bool(p.grad.abs().max() > 1e-12):
            assert moved, name
        if not p.requires_grad:
            assert not moved, name
    assert all(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()
               if ".prevout_attn." in n or ".previmage_attn." in n)
