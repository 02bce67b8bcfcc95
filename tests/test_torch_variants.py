"""The joint-encoder ablations in the port against the JAX package on the
CPU: `build_with_joint_encoder`'s joint, sequential and F2F encoders,
encode_offset with temporal positions, concat_imu; each parameter tree
against the JAX tree key for key; the weight bridge's refusals. The
detector's modes and attention capture are tests/test_torch_detector_modes.py,
which shares this file's helpers.

Each model is tiny (ResNet-50, D=32, 4 heads, 1+2 layers, 5 queries, 2 clips
x 3 frames of 64x128). Its JAX variables are `jax.eval_shape` of the init
filled from a numpy seed (no init compile; a leaf of one path and shape gets
the same values in every model), carried into the port by
utils/jax_weights.py, whose strict load also checks that the two trees have
the same keys both ways. The JAX forward runs eagerly (op by op, the
backbone's ops compiled once for every model of the file). About 40 s alone.
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

from future_od_tpu_torch.models import build
from future_od_tpu_torch.models.cores import FuturePredCore
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.utils.jax_weights import jax_to_state_dict, load_jax_variables, state_arrays
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_classes=4, hidden_dim=32, enc_nheads=4, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=48, num_queries=5, dropout=0.0)
B, L, H, W = 2, 3, 64, 128
IMU_WIDTHS = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
# f32 on both sides through the random ResNet-50, 1 encoder and 2 decoder
# layers (and the joint encoders): measured at most 1.3e-6 on scores and
# 7.6e-5 px on boxes of a 128-wide image; test_torch_flagship.py's bounds.
SCORE_ATOL = 1e-5
BOX_ATOL = 2e-3


def make_batch(seed=0, L=L):
    rng = np.random.default_rng(seed)
    batch = {"video": rng.normal(size=(B, L, H, W, 3)).astype(np.float32),
             "temporal_offsets": np.tile(np.array([-1.0, -0.4, 0.0][-L:], np.float32), (B, 1)),
             "annotated_frame_idx": np.full((B,), L - 1)}
    for key, width in IMU_WIDTHS.items():
        batch[key] = rng.normal(size=(B, L, width)).astype(np.float32)
    return batch


_FILLED = {}


def random_variables(shapes, seed=0):
    """The JAX tree of `shapes` filled from numpy seeds: weights at the
    fan-in scale, small biases, LayerNorm and BN scales near 1, positive BN
    variances (so no output saturates and every branch is live). A leaf's
    values follow from (seed, its path, its shape), and are drawn once."""

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        key = (seed, name, shape)
        if key not in _FILLED:
            _FILLED[key] = draw(np.random.default_rng([seed, *name.encode()]), name, shape)
        return _FILLED[key]
    return jax.tree_util.tree_map_with_path(fill, shapes)


def draw(rng, name, shape):
    if "running_var" in name:
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if "'scale'" in name or ("frozen" in name and "'weight'" in name):
        return rng.uniform(0.8, 1.2, shape).astype(np.float32)
    if len(shape) < 2:
        return rng.normal(0, 0.1, shape).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)


def jax_variables(model, batch, seed=0):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp_batch(batch)))
    return random_variables(shapes, seed)


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def scores_and_boxes(out):
    """sigmoid(logits) and pixel boxes of an output dict (numpy or torch)."""
    logits, boxes = (np.asarray(out[k].detach() if torch.is_tensor(out[k]) else out[k])
                     for k in ("pred_logits", "pred_boxes"))
    return 1.0 / (1.0 + np.exp(-logits)), boxes * np.array([W, H, W, H], np.float32)


def assert_outputs_match(out, ref):
    if "per_frame_preds" in ref:
        assert len(out["per_frame_preds"]) == len(ref["per_frame_preds"])
        for o, r in zip(out["per_frame_preds"], ref["per_frame_preds"]):
            assert_outputs_match(o, r)
        return
    (scores, boxes), (ref_scores, ref_boxes) = scores_and_boxes(out), scores_and_boxes(ref)
    assert scores.shape == ref_scores.shape and boxes.shape == ref_boxes.shape
    np.testing.assert_allclose(scores, ref_scores, atol=SCORE_ATOL)
    np.testing.assert_allclose(boxes, ref_boxes, atol=BOX_ATOL)


def jax_detector_model(args, **mode):
    core = JaxFuturePredCore(separate_encoder=jax_build._separate_encoder(args),
                             detector=jax_build._detector(args, 2, **mode))
    return JaxDETR(core=core, args=args)


def port_detector_model(args, **mode):
    return build.assemble(FuturePredCore(build._separate_encoder(args),
                                         build._detector(args, 2, **mode)), args, device="cpu")


def offset_models(args, pargs):
    """encode_offset with the temporal term (the joint variants' positions,
    from the batch's offsets)."""
    jargs, pargs = (type(a)(**{**TINY, "encode_offset": True}) for a in (args, pargs))
    core = JaxFuturePredCore(separate_encoder=jax_build._separate_encoder(jargs),
                             detector=jax_build._detector(jargs, 2), no_temporal_pos=False,
                             encode_offset=True)
    port = build.assemble(FuturePredCore(build._separate_encoder(pargs), build._detector(pargs, 2),
                                         no_temporal_pos=False, encode_offset=True),
                          pargs, device="cpu")
    return JaxDETR(core=core, args=jargs), port


def concat_models(args, pargs):
    core = JaxFuturePredCore(
        separate_encoder=jax_build._separate_encoder(args).clone(concat_imu=True),
        detector=jax_build._detector(args, 2))
    port = build.assemble(FuturePredCore(build._separate_encoder(pargs, concat_imu=True),
                                         build._detector(pargs, 2, use_egodeep=False)),
                          pargs, device="cpu")
    return JaxDETR(core=core, args=args), port


def variant_fixture(table, frames=None):
    """A module fixture: name -> (port model with the JAX weights, JAX
    model, JAX variables, batch) for each model of `table` (name -> a
    function of (JAX args, port args) giving (JAX model, port model)), on
    clips of `frames[name]` frames (default L), built on first use."""
    @pytest.fixture(scope="module")
    def variants():
        cache = {}

        def get(name):
            if name not in cache:
                jmodel, port = table[name](JaxArgs(**TINY), SpatioTemporalDETRArgs(**TINY))
                batch = make_batch(L=(frames or {}).get(name, L))
                variables = jax_variables(jmodel, batch)
                cache[name] = (load_jax_variables(port, variables), jmodel, variables, batch)
            return cache[name]
        return get
    return variants


def batch_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_variant(variants, name):
    port, jmodel, variables, batch = variants(name)
    ref = jmodel.apply(variables, jnp_batch(batch), deterministic=True)
    with torch.no_grad():
        out = port(batch_tensors(batch))
    assert_outputs_match(out, jax.tree.map(np.asarray, ref))


def check_tree(variants, name):
    """Both directions: every JAX leaf has its port parameter (the bridge
    places it) and every port parameter and buffer a JAX leaf."""
    port, _, variables, _ = variants(name)
    bridged = state_arrays(variables)
    own = port.state_dict()
    assert sorted(bridged) == sorted(own)
    for key, value in own.items():
        assert tuple(bridged[key].shape) == tuple(value.shape), key


# name -> (JAX model, port model) from (JAX args, port args)
VARIANTS = {
    "joint": lambda a, p: (jax_build.build_with_joint_encoder(a, "joint"),
                           build.build_with_joint_encoder(p, "joint", device="cpu")),
    "sequential": lambda a, p: (jax_build.build_with_joint_encoder(a, "sequential"),
                                build.build_with_joint_encoder(p, "sequential", device="cpu")),
    "f2f": lambda a, p: (jax_build.build_with_joint_encoder(a, "f2f"),
                         build.build_with_joint_encoder(p, "f2f", device="cpu")),
    "encode_offset": offset_models,
    "concat_imu": concat_models,
}
variants = variant_fixture(VARIANTS)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_equals_jax(variants, name):
    check_variant(variants, name)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_parameter_tree_is_the_jax_tree(variants, name):
    check_tree(variants, name)


def test_trees_without_jax_parameters_hold_no_module(variants):
    """The modules JAX creates only when it calls them: the sequential
    encoder's prevout and frame-memory attentions exist (frame 1 calls
    them), one frame-memory attention for 2 frames; concat_imu keeps the
    IMU MLP but no egodeep attention; F2F's first conv takes the 2 frames'
    channels."""
    seq = variants("sequential")[0].state_dict()
    assert any(".prevout_attn." in k for k in seq) and any(".previmage_attn.0." in k for k in seq)
    assert not any(".previmage_attn.1." in k for k in seq)
    concat = variants("concat_imu")[0].state_dict()
    assert any("imu_layers" in k for k in concat)
    assert not any("egodeep_attend" in k for k in concat)
    f2f = variants("f2f")[0].state_dict()
    assert f2f["_model.joint_encoder.convs.0.weight"].shape == (64, 64, 1, 1)
    assert f2f["_model.joint_encoder.convs.6.weight"].shape == (32, 32, 7, 7)


def test_bridge_refuses_a_missing_or_extra_key(variants):
    port, _, variables, _ = variants("sequential")
    detector = variables["params"]["core"]["detector"]
    extra = {**variables, "params": {**variables["params"], "core": {
        **variables["params"]["core"],
        "detector": {**detector, "stray": {"kernel": np.zeros((2, 2), np.float32)}}}}}
    with pytest.raises(ValueError, match="cannot place.*stray"):
        jax_to_state_dict(extra, device="cpu")
    layer = variables["params"]["core"]["joint_encoder"]["transformer"]["layer0"]
    missing = {**variables, "params": {**variables["params"], "core": {
        **variables["params"]["core"], "joint_encoder": {"transformer": {
            **variables["params"]["core"]["joint_encoder"]["transformer"],
            "layer0": {k: v for k, v in layer.items() if k != "prevout_attn"}}}}}}
    with pytest.raises(ValueError, match="unfilled.*prevout_attn"):
        load_jax_variables(port, missing)
    flagship = build.build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
    with pytest.raises(ValueError, match="lacks.*joint_encoder"):
        load_jax_variables(flagship, variables)


def test_list_outputs_normalize_and_post_process_as_jax():
    """A core's list of per-frame outputs (the JAX contract, which no core
    of the repo returns yet): stacked, each clip's annotated frame gathered
    with its aux levels, and post-processed per frame."""
    from future_od_tpu.models.st_detr import normalize_outputs as jax_normalize_outputs
    from future_od_tpu.models.st_detr import post_process as jax_post_process

    from future_od_tpu_torch.models.st_detr import normalize_outputs, post_process

    rng = np.random.default_rng(7)

    def level():
        return {"pred_logits": rng.normal(size=(B, 5, 4)).astype(np.float32),
                "pred_boxes": rng.uniform(0.1, 0.9, (B, 5, 4)).astype(np.float32)}
    outputs = [dict(level(), aux_outputs=[level(), level()]) for _ in range(L)]
    data = {"video": np.zeros((B, L, H, W, 3), np.float32),
            "annotated_frame_idx": np.array([2, 0])}
    ref = jax_normalize_outputs(jax.tree.map(jnp.asarray, outputs), jnp_batch(data))
    out = normalize_outputs(jax.tree.map(torch.from_numpy, outputs), batch_tensors(data))
    for mine, theirs in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert len(out[0]["aux_outputs"]) == 2 and out[1].shape == (B, L, 5, 4)
    ref_pp = jax_post_process(ref[1], ref[2], jnp_batch(data))
    out_pp = post_process(out[1], out[2], batch_tensors(data))
    for mine, theirs in zip(jax.tree.leaves(out_pp), jax.tree.leaves(ref_pp)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-5)
