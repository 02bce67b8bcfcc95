"""The PyTorch port's training slice against the JAX package, on the CPU.

Leaf functions (boxes, losses, targets, matching, the set criterion, the
optimizer, the mAP intermediaries) are held against their JAX counterparts on
numpy-seeded inputs. The whole train step is held against the JAX
`make_train_step` at tiny widths (ResNet-50, D=32, 4 heads, 1+1 layers, 8
queries): the port's weights are bridged into the JAX model, dropout is 0, the
exact Hungarian matcher runs on both sides, and the port routes its attention
through the training flash kernels' plain versions (FUTURE_OD_TRAIN_FLASH=1,
TRAIN_FLASH_MIN_KEYS lowered to this size's 4 tokens).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from future_od_tpu.metrics.od_map import prepare_od_map_stuffs as jax_prepare_od_map_stuffs
from future_od_tpu.models import set_criterion as jax_sc
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import STAT_IDFS as JAX_STAT_IDFS
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.ops import boxes as jax_boxes
from future_od_tpu.ops import losses as jax_losses
from future_od_tpu.ops import matching as jax_matching
from future_od_tpu.ops.target_utils import to_detr_targets as jax_to_detr_targets
from future_od_tpu.train import optimizer as jax_opt
from future_od_tpu.train.step import TrainState
from future_od_tpu.train.step import make_train_step as jax_make_train_step

from future_od_tpu_torch.metrics.od_map import prepare_od_map_stuffs
from future_od_tpu_torch.models import layers as port_layers
from future_od_tpu_torch.models import set_criterion as sc
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import STAT_IDFS, SpatioTemporalDETRArgs
from future_od_tpu_torch.ops import boxes, losses, matching
from future_od_tpu_torch.ops import flash_attention as fa
from future_od_tpu_torch.ops.target_utils import to_detr_targets
from future_od_tpu_torch.train import optimizer as opt
from future_od_tpu_torch.train.step import make_train_step
from future_od_tpu_torch.utils.jax_weights import (
    flagship_state_arrays,
    load_jax_train_state,
    load_jax_variables,
)

TINY = dict(
    num_classes=4, num_queries=8, hidden_dim=32, enc_layers=1, dec_layers=1,
    dim_feedforward=64, enc_nheads=4, nheads=4, dropout=0.0,
    matcher="hungarian",
)
B, L, H, W, N = 2, 3, 64, 64, 8
STEPS = 3
# f32 on both sides: leaf functions agree to rounding; the whole forward
# reassociates through ResNet-50 and the transformer (the flagship tests
# allow 1e-5 on scores).
ATOL = 1e-5
LOSS_RTOL = 1e-4
# First-step gradients, per tensor, as a fraction of max |grad| (floored at
# GRAD_FLOOR of the model's largest, for gradients that are zero but for
# rounding: key biases under softmax's shift invariance, and decoder layer
# 0's self-attention q/k, whose values are all equal). f32 rounding grows
# through the random-init ResNet and the 4-token encoder attention: measured
# gaps 1e-4 in the detector and 2e-3 in the separate encoder (backbone and
# encoder); each tolerance is 10x that.
GRAD_TOL = {"detector": 1e-3, "separate_encoder": 2e-2}
GRAD_FLOOR = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def make_data(seed, B=B, L=L, H=H, W=W, N=N, num_classes=4):
    """A numpy batch in the JAX package's layout (tests/test_models.py)."""
    rng = np.random.default_rng(seed)
    wh = np.abs(rng.normal(size=(B, N, 4))).astype(np.float32) * 20
    data = {
        "video": rng.normal(size=(B, L, H, W, 3)).astype(np.float32),
        "boxes": np.concatenate([wh[..., :2], wh[..., :2] + wh[..., 2:]], -1),
        "classes": rng.integers(0, num_classes, size=(B, N)),
        "active": (rng.uniform(size=(B, N)) < 0.5).astype(np.int64),
        "annotated_frame_idx": np.full((B,), L - 1),
    }
    for key, d in [("translation", 3), ("acceleration", 3), ("rotation", 4),
                   ("rotation_rate", 3), ("speed", 1)]:
        data[key] = rng.normal(size=(B, L, d)).astype(np.float32)
    return data


def random_xyxy(rng, *shape):
    lo = rng.uniform(0, 1, size=shape + (2,))
    return np.concatenate([lo, lo + rng.uniform(0.01, 1, size=shape + (2,))], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# leaf functions


class TestBoxes:
    @pytest.mark.parametrize("name", [
        "box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area", "box_iou",
        "generalized_box_iou", "batched_box_iou",
    ])
    def test_pairwise_and_conversions_equal_jax(self, rng, name):
        a, b = random_xyxy(rng, 3, 7), random_xyxy(rng, 3, 5)
        one_arg = name in ("box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area")
        ref = getattr(jax_boxes, name)(*((jnp.asarray(a),) if one_arg else (jnp.asarray(a), jnp.asarray(b))))
        out = getattr(boxes, name)(*((t(a),) if one_arg else (t(a), t(b))))
        for o, r in zip(*((out, ref) if isinstance(out, tuple) else ((out,), (ref,)))):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=1e-6)

    def test_elementwise_giou_equals_jax(self, rng):
        a, b = random_xyxy(rng, 4, 9), random_xyxy(rng, 4, 9)
        ref = jax_boxes.elementwise_generalized_box_iou(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(boxes.elementwise_generalized_box_iou(t(a), t(b)).numpy(),
                                   np.asarray(ref), atol=ATOL)


class TestLosses:
    def test_bce_and_focal_equal_jax(self, rng):
        logits = rng.normal(0, 3, size=(2, 6, 4)).astype(np.float32)
        targets = (rng.uniform(size=(2, 6, 4)) < 0.3).astype(np.float32)
        np.testing.assert_allclose(
            losses.sigmoid_binary_cross_entropy(t(logits), t(targets)).numpy(),
            np.asarray(jax_losses.sigmoid_binary_cross_entropy(jnp.asarray(logits),
                                                               jnp.asarray(targets))),
            atol=ATOL)
        for alpha in (0.25, -1.0):
            ref = jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                                jnp.float32(3.0), alpha=alpha)
            out = losses.sigmoid_focal_loss(t(logits), t(targets), torch.tensor(3.0), alpha=alpha)
            np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)

    def test_class_error_equals_jax(self, rng):
        logits = rng.normal(size=(3, 5, 4)).astype(np.float32)
        classes = rng.integers(0, 4, size=(3, 5))
        valid = rng.uniform(size=(3, 5)) < 0.6
        ref = jax_losses.class_error(jnp.asarray(logits), jnp.asarray(classes), jnp.asarray(valid))
        out = losses.class_error(t(logits), t(classes), t(valid))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)

    def test_to_detr_targets_equals_jax(self):
        data = make_data(1)
        ref = jax_to_detr_targets(64, 96, jnp.asarray(data["active"]), jnp.asarray(data["boxes"]),
                                  jnp.asarray(data["classes"]))
        out = to_detr_targets(64, 96, t(data["active"]), t(data["boxes"]), t(data["classes"]))
        np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=1e-6)
        np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref["labels"]))
        np.testing.assert_array_equal(out["active"].numpy(), np.asarray(ref["active"]))


def random_problem(seed, B=3, M=16, N=10, C=4, p_active=0.7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(B, M, C)).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)), rng.uniform(0.05, 0.4, (B, M, 2))],
                          -1).astype(np.float32)
    targets = {
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                                 rng.uniform(0.05, 0.4, (B, N, 2))], -1).astype(np.float32),
        "labels": rng.integers(0, C, size=(B, N)).astype(np.int32),
        "active": rng.uniform(size=(B, N)) < p_active,
    }
    return logits, pred, targets


class TestMatching:
    def test_matching_cost_equals_jax(self):
        logits, pred, targets = random_problem(0)
        ref = jax_matching.matching_cost(jnp.asarray(logits), jnp.asarray(pred),
                                         {k: jnp.asarray(v) for k, v in targets.items()})
        out = matching.matching_cost(t(logits), t(pred), {k: t(v) for k, v in targets.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("kind", ["normal", "ties", "detr"])
    def test_auction_indices_and_rounds_equal_jax(self, seed, kind):
        rng = np.random.default_rng(seed)
        B, M, N = 4, 16, 10
        active = rng.uniform(size=(B, N)) < 0.7
        active[0] = False  # a problem with nothing to match
        if kind == "detr":
            logits, pred, targets = random_problem(seed, B=B, M=M, N=N)
            targets["active"] = active
            cost = np.asarray(jax_matching.matching_cost(
                jnp.asarray(logits), jnp.asarray(pred),
                {k: jnp.asarray(v) for k, v in targets.items()}))
        else:
            cost = rng.normal(size=(B, M, N)).astype(np.float32)
            if kind == "ties":  # many equal benefits: tie order must match
                cost = np.round(cost * 2) / 2
        idx, rounds = jax_matching.auction_assignment(jnp.asarray(cost), jnp.asarray(active),
                                                      return_rounds=True)
        out_idx, out_rounds = matching.auction_assignment(t(cost), t(active), return_rounds=True)
        np.testing.assert_array_equal(out_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(out_rounds.numpy(), np.asarray(rounds))

    def test_auction_at_the_flagship_slots_equals_jax(self):
        """128 queries, 128 cost slots, about 10% active, as the train step."""
        logits, pred, targets = random_problem(7, B=2, M=128, N=128, C=8, p_active=0.1)
        cost = jax_matching.matching_cost(jnp.asarray(logits), jnp.asarray(pred),
                                          {k: jnp.asarray(v) for k, v in targets.items()})
        idx = jax_matching.auction_assignment(cost, jnp.asarray(targets["active"]))
        out = matching.auction_assignment(t(np.asarray(cost)), t(targets["active"]))
        np.testing.assert_array_equal(out.numpy(), np.asarray(idx))

    @pytest.mark.parametrize("seed", range(3))
    def test_hungarian_equals_jax_host_solver(self, seed):
        rng = np.random.default_rng(seed)
        cost = rng.normal(size=(3, 12, 7)).astype(np.float32)
        active = rng.uniform(size=(3, 7)) < 0.6
        ref = jax_matching._hungarian_host(cost, active)
        out, rounds = matching.hungarian_assignment(t(cost), t(active), return_rounds=True)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert not rounds.any()


def criterion_problem(seed):
    """Preds with one aux level, dense targets (B, N) and a random injected
    assignment per level (as tests/test_criterion_grad_oracle.py)."""
    rng = np.random.default_rng(seed)
    Bc, M, C, Nc = 2, 6, 4, 5
    active = np.zeros((Bc, Nc), bool)
    active[0, [0, 2, 3]] = True
    active[1, [4]] = True
    targets = {
        "labels": rng.integers(0, C, (Bc, Nc)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (Bc, Nc, 2)),
                                 rng.uniform(0.1, 0.3, (Bc, Nc, 2))], -1).astype(np.float32),
        "active": active,
    }

    def level():
        return {"pred_logits": rng.normal(0, 1, (Bc, M, C)).astype(np.float32),
                "pred_boxes": rng.uniform(0.2, 0.8, (Bc, M, 4)).astype(np.float32)}

    outputs = level()
    outputs["aux_outputs"] = [level()]
    return outputs, targets, C


CRITERION_CASES = {
    "injected": dict(),
    "auction": dict(),
    "hungarian": dict(matcher="hungarian"),
    "compacted": dict(cost_slots=3),  # 3 slots: image 0's third target is dropped
    "last level": dict(matching_mode="last level"),
}


class TestSetCriterion:
    @pytest.mark.parametrize("case", list(CRITERION_CASES))
    def test_losses_and_grads_equal_jax(self, case):
        outputs, targets, C = criterion_problem(11)
        kw = CRITERION_CASES[case]
        jcfg = jax_sc.CriterionConfig(num_classes=C, **kw)
        cfg = sc.CriterionConfig(num_classes=C, **kw)
        injected = None
        if case == "injected":
            rng = np.random.default_rng(3)
            injected = np.full((2, 2, 5), 6, np.int64)
            for a in range(2):
                for b in range(2):
                    slots = np.nonzero(targets["active"][b])[0]
                    injected[a, b, slots] = rng.choice(6, size=len(slots), replace=False)

        def jax_total(out):
            losses_ = jax_sc.set_criterion(
                out, {k: jnp.asarray(v) for k, v in targets.items()}, jcfg,
                None if injected is None else jnp.asarray(injected.astype(np.int32)))
            return jax_sc.weighted_total(losses_, jcfg, 1)[0], losses_

        jout = jax.tree.map(jnp.asarray, outputs)
        (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(jout)

        tout = jax.tree.map(lambda a: t(a).requires_grad_(True), outputs)
        plosses = sc.set_criterion(
            tout, {k: t(v) for k, v in targets.items()}, cfg,
            None if injected is None else t(injected))
        total, _ = sc.weighted_total(plosses, cfg, 1)
        total.backward()
        assert set(plosses) == set(jlosses)
        for k, v in jlosses.items():
            np.testing.assert_allclose(plosses[k].item(), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
        for lvl, jlvl in ((tout, jgrads), (tout["aux_outputs"][0], jgrads["aux_outputs"][0])):
            for key in ("pred_logits", "pred_boxes"):
                np.testing.assert_allclose(lvl[key].grad.numpy(), np.asarray(jlvl[key]),
                                           rtol=1e-4, atol=1e-6, err_msg=key)


class TestOdMap:
    def test_intermediaries_equal_jax(self, rng):
        Bm, Mp, C, Nm = 2, 60, 5, 9
        pred_boxes = random_xyxy(rng, Bm, Mp) * 50
        scores = rng.uniform(size=(Bm, Mp, C)).astype(np.float32)
        scores[:, 10:20] = scores[:, :10]  # equal scores: the top-K order must tie-break alike
        anno = random_xyxy(rng, Bm, Nm) * 50
        anno[:, :4] = pred_boxes[:, :4] + 0.5  # some true positives
        classes = rng.integers(0, C - 1, size=(Bm, Nm))
        active = (rng.uniform(size=(Bm, Nm)) < 0.7).astype(np.int64)
        ref = jax_prepare_od_map_stuffs(jnp.asarray(pred_boxes), jnp.asarray(scores),
                                        jnp.asarray(anno), jnp.asarray(classes),
                                        jnp.asarray(active), (50, 60))
        out = prepare_od_map_stuffs(t(pred_boxes), t(scores), t(anno), t(classes), t(active),
                                    (50, 60))
        for o, r in zip(out, ref):
            if o.dtype == torch.bool or o.dtype == torch.int32:
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))
            else:
                np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
        assert out[1].any()


# ---------------------------------------------------------------------------
# optimizer


class ToyModel(nn.Module):
    """Parameters named as the flagship's groups: a frozen stem, a backbone
    stage and a head."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.ModuleDict({"body": nn.ModuleDict({
            "conv1": nn.Linear(3, 4), "layer2": nn.Linear(4, 4)})})
        self.head = nn.Linear(4, 2)


def toy_jax_params(model):
    """The toy model's parameters as a JAX tree of the same paths."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


class TestOptimizer:
    def test_lr_schedule_equals_jax(self):
        f, g = opt.get_lr_func(100), jax_opt.get_lr_func(100)
        assert [f(e) for e in range(100)] == [g(e) for e in range(100)]

    @pytest.mark.parametrize("scale", [1e-3, 1.0, float("nan")])
    def test_clip_equals_optax(self, rng, scale):
        grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,))]
        clip = optax.clip_by_global_norm(0.1)
        ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
        tg = [t(g) for g in grads]
        opt.clip_by_global_norm_(tg, opt.global_norm(tg), 0.1)
        for o, r in zip(tg, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))

    def test_adamw_updates_equal_optax(self, rng):
        torch.manual_seed(0)
        model = ToyModel()
        params = toy_jax_params(model)
        tx, state = jax_opt.build_optimizer(params, lr=1e-3, lr_backbone=1e-4,
                                            weight_decay=1e-2, max_norm=0.1)
        optimizer = opt.build_optimizer(model, lr=1e-3, lr_backbone=1e-4, weight_decay=1e-2,
                                        max_norm=0.1)
        assert [g["name"] for g in optimizer.param_groups] == ["main", "backbone"]
        named = dict(model.named_parameters())
        for _ in range(3):
            grads = {n: rng.normal(size=p.shape).astype(np.float32) for n, p in named.items()}
            jgrads = jax.tree_util.tree_map_with_path(
                lambda path, _: jnp.asarray(grads[".".join(k.key for k in path)]), params)
            updates, state = jax.jit(tx.update)(jgrads, state, params)
            params = optax.apply_updates(params, updates)
            for n, p in named.items():
                p.grad = t(grads[n]) if opt.param_label(n) != "frozen" else None
            live = [p.grad for p in optimizer.parameters()]
            opt.clip_by_global_norm_(live, opt.global_norm(live), optimizer.max_norm)
            optimizer.step()
        flat = {".".join(k.key for k in path): v
                for path, v in jax.tree_util.tree_leaves_with_path(params)}
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[n]), rtol=0, atol=1e-7,
                                       err_msg=n)

    def test_set_learning_rates(self):
        optimizer = opt.build_optimizer(ToyModel(), lr=1e-3, lr_backbone=1e-4)
        opt.set_learning_rates(optimizer, 5e-4, 5e-5)
        assert [g["lr"] for g in optimizer.param_groups] == [5e-4, 5e-5]


# ---------------------------------------------------------------------------
# the whole train step


def port_args(**kw):
    return SpatioTemporalDETRArgs(**{**TINY, **kw})


def randomized_port_model(args, seed=0):
    """A port flagship on the CPU with its zero-init bbox delta layer and
    focal-prior class bias randomized (so every head gradient is live)."""
    model = build_flagship(args, device="cpu", generator=torch.Generator().manual_seed(seed))
    det, gen = model._model.detector, torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p, std in ((det.bbox_embed.layers[-1].weight, 0.1), (det.bbox_embed.layers[-1].bias, 0.1),
                       (det.class_embed.bias, 1.0)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """The JAX train step's trajectory over STEPS steps: per step the loss,
    stats, params and opt_state. The detection heads' zero-init bbox delta
    layer and focal-prior class bias are randomized, so that every head
    gradient is live."""
    args = port_args()
    data = make_data(0)
    jmodel = jax_build_flagship(JaxArgs(**TINY))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax_tree_np(jax.jit(lambda k: jmodel.init({"params": k}, jdata))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    detector = variables["params"]["core"]["detector"]
    last = detector["bbox_embed"]["layer2"]
    last["kernel"] = rng.normal(0, 0.1, last["kernel"].shape).astype(np.float32)
    last["bias"] = rng.normal(0, 0.1, last["bias"].shape).astype(np.float32)
    detector["class_embed"]["bias"] = rng.normal(0, 1.0, (TINY["num_classes"],)).astype(np.float32)
    tx, opt_state = jax_opt.build_optimizer(
        variables["params"], lr=args.lr, lr_backbone=args.lr_backbone,
        weight_decay=args.weight_decay, max_norm=args.max_norm)
    state = TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))
    step = jax.jit(jax_make_train_step(jmodel, JaxArgs(**TINY).criterion_config(), tx))
    trajectory = []
    for _ in range(STEPS):
        state, loss, stats, _, _ = step(state, jdata, jax.random.key(1))
        trajectory.append(dict(loss=float(loss), stats=jax_tree_np(stats),
                               variables={"params": jax_tree_np(state.params),
                                          "frozen": variables["frozen"]},
                               opt_state=jax.tree.map(np.asarray, state.opt_state)))
    return dict(args=args, data=data, variables=variables, trajectory=trajectory)


def port_trainer(reference, monkeypatch, **kw):
    """(model, optimizer, train_step) of the port from the reference's
    initial weights, attention through the train flash kernels' plain
    versions."""
    monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
    monkeypatch.setattr(port_layers, "TRAIN_FLASH_MIN_KEYS", 1)
    args = dataclasses.replace(reference["args"], **kw)
    model = build_flagship(args, device="cpu")
    load_jax_variables(model, reference["variables"])
    optimizer = opt.build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                    args.max_norm, args.freeze_stem)
    return model, optimizer, make_train_step(model, args.criterion_config(), optimizer,
                                             device="cpu")


def flagship_names_to_numpy(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def group_lr(args, name):
    return args.lr_backbone if opt.param_label(name) == "backbone" else args.lr


class TestTrainStep:
    def test_tracks_jax_over_three_steps(self, reference, monkeypatch):
        model, optimizer, step = port_trainer(reference, monkeypatch)
        flash = []
        original = port_layers.flash_attention_train
        monkeypatch.setattr(port_layers, "flash_attention_train",
                            lambda *a, **k: flash.append(1) or original(*a, **k))
        args, ref = reference["args"], reference["trajectory"]
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not p.requires_grad}
        assert frozen and all(opt.param_label(n) == "frozen" for n in frozen)
        for i in range(STEPS):
            loss, stats, od_map, output = step(reference["data"], 0)
            np.testing.assert_allclose(float(loss), ref[i]["loss"], rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1}")
            assert set(stats) == set(ref[i]["stats"]) == set(STAT_IDFS) | {"nonfinite_skipped"}
            assert float(stats["nonfinite_skipped"]) == 0.0
            for k in ("labels", "box_l1", "box_giou", "cardinality", "class_error"):
                np.testing.assert_allclose(float(stats[k]), float(ref[i]["stats"][k]),
                                           rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
            if i == 0:
                self._first_step_grads_equal_jax(model, ref[0])
        # 1 encoder self-attention + 1 decoder layer x 2 image memories per step
        assert len(flash) == 3 * STEPS
        assert set(STAT_IDFS) == set(JAX_STAT_IDFS)
        want = flagship_state_arrays(ref[-1]["variables"])
        for name, p in model.named_parameters():
            # AdamW moves an element at most lr per step (sign-like early on)
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                       atol=2 * STEPS * group_lr(args, name), err_msg=name)
        for name, before in frozen.items():
            assert torch.equal(dict(model.named_parameters())[name], before), name
        assert od_map[0].shape[1] == 5 and output["boxes"].shape == (B, 1, 1, 8, 4)

    @staticmethod
    def _first_step_grads_equal_jax(model, ref0):
        """The port's clipped gradients equal JAX's, read from optax's first
        moment after one step (mu = (1 - b1) g): max |difference| within
        GRAD_TOL of max(max |grad|, GRAD_FLOOR x the model's largest)."""
        from future_od_tpu_torch.utils.jax_weights import _adam_states, _merge

        adam = list(_adam_states(ref0["opt_state"]))
        mu = flagship_state_arrays({
            "params": _merge([s.mu for s in adam], ref0["variables"]["params"]),
            "frozen": ref0["variables"]["frozen"]})
        grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
        floor = GRAD_FLOOR * max(np.abs(mu[n]).max() / 0.1 for n in grads)
        for name, g in grads.items():
            want = mu[name] / 0.1
            tol = GRAD_TOL[name.split(".")[1]] * max(np.abs(want).max(), floor)
            np.testing.assert_allclose(g, want, rtol=0, atol=tol, err_msg=name)
        assert len(grads) > 100

    def test_optimizer_state_carried_from_jax(self, reference, monkeypatch):
        """load_jax_train_state after two JAX steps, then one port step,
        equals the JAX trajectory's third step."""
        model, optimizer, step = port_trainer(reference, monkeypatch)
        ref = reference["trajectory"]
        load_jax_train_state(model, optimizer, ref[1]["variables"], ref[1]["opt_state"])
        assert all(float(s["step"]) == 2.0 for s in optimizer.state.values())
        loss, *_ = step(reference["data"], 0)
        np.testing.assert_allclose(float(loss), ref[2]["loss"], rtol=LOSS_RTOL)
        want = flagship_state_arrays(ref[2]["variables"])
        args = reference["args"]
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                       atol=2 * group_lr(args, name), err_msg=name)

    def test_param_labels_equal_jax_through_the_bridge(self, reference):
        variables = reference["variables"]
        codes = {"main": 1.0, "backbone": 2.0, "frozen": 3.0}
        labels = jax_opt.param_labels(variables["params"])
        coded = jax.tree.map(lambda l, p: np.full(np.shape(p), codes[l], np.float32),
                             labels, variables["params"])
        arrays = flagship_state_arrays({"params": coded, "frozen": variables["frozen"]})
        model = build_flagship(reference["args"], device="cpu")
        port = opt.param_labels(model)
        assert set(port.values()) == set(codes)
        for name, label in port.items():
            assert set(np.unique(arrays[name])) == {codes[label]}, name

    def test_nonfinite_gradient_skips_the_update(self, reference, monkeypatch):
        # the auction, as the JAX package's guard test: scipy's exact solver
        # refuses a NaN cost
        model, optimizer, step = port_trainer(reference, monkeypatch, matcher="auction")
        step(reference["data"], 0)  # moments exist
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        moments = {id(p): {k: v.clone() for k, v in s.items()} for p, s in optimizer.state.items()}
        poisoned = dict(reference["data"], video=reference["data"]["video"].copy())
        poisoned["video"][0, 0, 0, 0, 0] = np.nan
        loss, stats, *_ = step(poisoned, 0)
        assert float(stats["nonfinite_skipped"]) == 1.0 and not np.isfinite(float(loss))
        assert step.steps[0] == 2
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), params[n]), n
        for p, s in optimizer.state.items():
            for k, v in s.items():
                assert torch.equal(v, moments[id(p)][k]), k


class TestGateAndSeeding:
    @pytest.fixture
    def tiny(self):
        model = randomized_port_model(port_args(dropout=0.1))
        return model, make_data(4)

    @pytest.mark.parametrize("training,env,min_keys,calls", [
        (True, {"FUTURE_OD_TRAIN_FLASH": "1"}, 1, 3),
        (True, {}, 1, 0),
        (False, {"FUTURE_OD_TRAIN_FLASH": "1"}, 1, 0),
        (True, {"FUTURE_OD_TRAIN_FLASH": "1"}, 256, 0),  # 4 tokens < 256 keys
        (True, {"FUTURE_OD_TRAIN_FLASH": "1", "FUTURE_OD_DISABLE_FLASH": "1"}, 1, 0),
    ])
    def test_gate_routes_training_attention(self, tiny, monkeypatch, training, env, min_keys,
                                            calls):
        model, data = tiny
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(port_layers, "TRAIN_FLASH_MIN_KEYS", min_keys)
        seen = []
        original = fa.FlashAttentionTrain.apply
        monkeypatch.setattr(fa.FlashAttentionTrain, "apply",
                            lambda *a: seen.append(1) or original(*a))
        model.train(training)
        with torch.no_grad():
            model({k: torch.as_tensor(v) for k, v in data.items()})
        assert len(seen) == calls

    @pytest.mark.parametrize("nk,calls", [(255, 0), (256, 1)])
    def test_gate_key_floor(self, monkeypatch, nk, calls):
        monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
        seen = []
        original = port_layers.flash_attention_train
        monkeypatch.setattr(port_layers, "flash_attention_train",
                            lambda *a, **k: seen.append(a[3]) or original(*a, **k))
        drop = nn.Dropout(0.1).train()
        qh, kh = torch.randn(1, 3, 2, 32), torch.randn(1, nk, 2, 32)
        out = port_layers.attend_heads(qh, kh, torch.randn(1, nk, 2, 32), 0.2, drop)
        assert out.shape == (1, 3, 64) and len(seen) == calls
        assert all(0 <= s < 2**31 - 1 for s in seen)

    def test_one_seed_gives_identical_steps(self, monkeypatch):
        monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
        monkeypatch.setattr(port_layers, "TRAIN_FLASH_MIN_KEYS", 1)
        data, results = make_data(5), []
        for seed in (3, 3, 4):
            args = port_args(dropout=0.1, matcher="auction")
            model = randomized_port_model(args)
            optimizer = opt.build_optimizer(model, args.lr, args.lr_backbone)
            step = make_train_step(model, args.criterion_config(), optimizer, device="cpu")
            rng_before = torch.get_rng_state()
            losses_ = [float(step(data, seed)[0]) for _ in range(2)]
            assert torch.equal(torch.get_rng_state(), rng_before)  # the global RNG is untouched
            results.append((losses_, flagship_names_to_numpy(model)))
        assert results[0][0] == results[1][0] and results[0][0] != results[2][0]
        for name, value in results[0][1].items():
            np.testing.assert_array_equal(value, results[1][1][name], err_msg=name)


class TestEntryPoints:
    def test_train_step_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        args = port_args()
        model = build_flagship(args, device="cpu")
        optimizer = opt.build_optimizer(model, args.lr, args.lr_backbone)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(model, args.criterion_config(), optimizer)

    @pytest.mark.parametrize("kw", [dict(mixed_precision=True), dict(accum_steps=2)])
    def test_precision_options_take_a_step(self, kw):
        """The options the step refused before it had them: one step each
        (tests/test_torch_mixed_precision.py holds them against JAX)."""
        args = port_args()
        model = randomized_port_model(args)
        optimizer = opt.build_optimizer(model, args.lr, args.lr_backbone)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_train_step(model, args.criterion_config(), optimizer, device="cpu", **kw)
        loss, stats, _, output = step(make_data(7), 0)
        assert np.isfinite(float(loss)) and float(stats["nonfinite_skipped"]) == 0.0
        assert output["boxes"].shape == (B, 1, 1, TINY["num_queries"], 4)
        moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
        assert len(moved) > 100 and all(p.dtype == torch.float32 for p in model.parameters())

    def test_aux_outputs_only_in_training(self):
        model = build_flagship(dataclasses.replace(port_args(), dec_layers=3), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in make_data(6).items()}
        with torch.no_grad():
            assert "aux_outputs" not in model.eval()(batch)
            out = model.train()(batch)
        assert len(out["aux_outputs"]) == 2
        assert out["aux_outputs"][0]["pred_boxes"].shape == out["pred_boxes"].shape
