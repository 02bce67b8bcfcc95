"""The PyTorch port's flagship inference path against the JAX package.

A tiny flagship (ResNet-50, D=32, 4 heads, 2+2 layers, 5 queries, 3 frames at
64x96) is initialized in JAX, its variables are bridged into the port
(utils/jax_weights.py), and one numpy-seeded batch goes through both
`make_inference_fn`s on the CPU. The JAX side runs its plain einsum/conv path
(its Pallas gates are off on the CPU); the port runs each gate setting, so the
kernels' wrappers (which take their plain versions on CPU tensors) and the
BN folding / weight layouts behind them are exercised.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train.step import make_inference_fn as jax_make_inference_fn
from future_od_tpu.utils.checkpoint_convert import convert_reference_checkpoint

from future_od_tpu_torch.models import layers as port_layers
from future_od_tpu_torch.models import resnet as port_resnet
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
from future_od_tpu_torch.train.step import make_inference_fn, to_device_batch
from future_od_tpu_torch.utils.jax_weights import jax_to_state_dict, load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    num_classes=4, hidden_dim=32, enc_nheads=4, nheads=4, enc_layers=2,
    dec_layers=2, dim_feedforward=48, num_queries=5, dropout=0.0,
)
IMU_SHAPES = {
    "translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1,
}
# f32 on both sides; the 50-layer trunk, 2 encoder and 2 decoder layers
# accumulate reassociation noise (the torch oracle of
# test_full_model_torch_oracle.py allows 3e-3 on logits and [0, 1] boxes).
# Scores are sigmoids in [0, 1]; boxes are pixels of a 64x96 image.
SCORE_ATOL = 1e-5
BOX_ATOL = 2e-3


def make_batch(rng, B=1, L=3, H=64, W=96):
    batch = {"video": rng.normal(size=(B, L, H, W, 3)).astype(np.float32)}
    for key, width in IMU_SHAPES.items():
        batch[key] = rng.normal(size=(B, L, width)).astype(np.float32)
    return batch


def randomize_heads_and_bn(variables, rng, hidden_dim, num_classes):
    """Randomize the zero-initialized bbox head and the focal-prior class
    bias, and jitter the frozen BN statistics, so that head and BN-folding
    errors cannot hide (with the init's heads, boxes do not depend on the
    image)."""
    detector = variables["params"]["core"]["detector"]
    detector["bbox_embed"]["layer2"] = {
        "kernel": rng.normal(0, 0.1, (hidden_dim, 4)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (4,)).astype(np.float32),
    }
    detector["class_embed"]["bias"] = rng.normal(0, 1.0, (num_classes,)).astype(np.float32)
    variables["frozen"] = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.05, x.shape)).astype(np.float32),
        variables["frozen"],
    )
    return variables


def tiny_jax_flagship(seed=0):
    """(JAX model, numpy variables, numpy batch), heads and BN randomized."""
    rng = np.random.default_rng(seed)
    model = jax_build_flagship(JaxArgs(**TINY))
    batch = make_batch(rng)
    variables = model.init(
        jax.random.key(seed), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    variables = randomize_heads_and_bn(
        jax.tree.map(np.asarray, variables), rng, TINY["hidden_dim"], TINY["num_classes"]
    )
    return model, variables, batch


@pytest.fixture(scope="module")
def jax_reference():
    model, variables, batch = tiny_jax_flagship()
    out = jax_make_inference_fn(model)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    return variables, batch, jax.tree.map(np.asarray, out)


def port_inference(variables, batch):
    model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
    load_jax_variables(model, variables)
    return make_inference_fn(model, device="cpu")(batch)


def assert_matches(out, ref):
    assert out["class_scores"].shape == ref["class_scores"].shape == (1, 1, 1, 5, 5)
    assert out["boxes"].shape == ref["boxes"].shape == (1, 1, 1, 5, 4)
    np.testing.assert_allclose(out["class_scores"].numpy(), ref["class_scores"], atol=SCORE_ATOL)
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], atol=BOX_ATOL)


def counting(monkeypatch, module, name):
    """Wrap module.<name> so each call is counted."""
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


class TestFlagshipInference:
    def test_default_gates(self, jax_reference, monkeypatch):
        variables, batch, ref = jax_reference
        flash = counting(monkeypatch, port_layers, "flash_attention")
        assert_matches(port_inference(variables, batch), ref)
        assert not flash  # 6 tokens: below the 1024-key flash gate

    def test_flash_gates_lowered(self, jax_reference, monkeypatch):
        variables, batch, ref = jax_reference
        monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
        monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
        flash = counting(monkeypatch, port_layers, "flash_attention")
        assert_matches(port_inference(variables, batch), ref)
        # 2 encoder self-attentions + 2 decoder layers x 2 image attentions
        assert len(flash) == 2 + 2 * 2

    def test_flash_disabled(self, jax_reference, monkeypatch):
        variables, batch, ref = jax_reference
        monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
        monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
        monkeypatch.setenv("FUTURE_OD_DISABLE_FLASH", "1")
        flash = counting(monkeypatch, port_layers, "flash_attention")
        assert_matches(port_inference(variables, batch), ref)
        assert not flash

    def test_fused_resnet_gates(self, jax_reference, monkeypatch):
        # 64x96 meets the stem gate (H % 32, W % 4) and every layer1/layer2
        # stride-1 block's (H % 8)
        variables, batch, ref = jax_reference
        monkeypatch.setenv("FUTURE_OD_FUSED_RESNET", "1")
        monkeypatch.setenv("FUTURE_OD_FUSED_STEM", "1")
        blocks = counting(monkeypatch, port_resnet, "fused_bottleneck_packed")
        stem = counting(monkeypatch, port_resnet, "fused_stem_packed")
        assert_matches(port_inference(variables, batch), ref)
        assert len(blocks) == 3 + 3 and len(stem) == 1

    def test_fuse_stages_env(self, jax_reference, monkeypatch):
        variables, batch, ref = jax_reference
        monkeypatch.setenv("FUTURE_OD_FUSED_RESNET", "1")
        monkeypatch.setenv("FUTURE_OD_FUSE_STAGES", "0")
        blocks = counting(monkeypatch, port_resnet, "fused_bottleneck_packed")
        stem = counting(monkeypatch, port_resnet, "fused_stem_packed")
        assert_matches(port_inference(variables, batch), ref)
        assert len(blocks) == 3 and not stem  # layer1 only; stem gate off


# The repo's configs at their widths, depth cut to one encoder and one
# decoder layer: the flagship (hidden 256 over 8 heads) and
# runs/nuim_single_frame.py --debug (hidden 64 over 4 heads; the port builds
# its widths as a flagship).
REPO_CONFIGS = {
    "flagship": dict(num_classes=8, num_queries=128),
    "single_frame_debug": dict(num_classes=2, num_queries=16, hidden_dim=64,
                               dim_feedforward=128, enc_nheads=4, nheads=4),
    # a wider member of the family: heads of 128, its cross-attention's concat
    # heads 256/128 (K4-K6 take the decoder's ones in training)
    "hidden_1024": dict(num_classes=8, num_queries=16, hidden_dim=1024, enc_nheads=8,
                        nheads=8),
}
# a pair each config must reach (the widest it asks for)
WIDEST_PAIR = {"flagship": (64, 32), "single_frame_debug": (32, 16), "hidden_1024": (256, 128)}


@pytest.mark.parametrize("config", sorted(REPO_CONFIGS))
def test_repo_configs_reach_built_head_dims(config, monkeypatch):
    """With every flash gate lowered to one key, each attention of the
    config, in inference and in training, reaches the kernels' wrappers at a
    head-dim pair they are built for: on the card none raises."""
    monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
    monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
    monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
    monkeypatch.setattr(port_layers, "TRAIN_FLASH_MIN_KEYS", 1)
    pairs = []
    for name in ("flash_attention", "flash_attention_train"):
        def record(q, k, v, *rest, _original=getattr(port_layers, name), _name=name):
            pairs.append((_name, q.shape[-1], v.shape[-1]))
            return _original(q, k, v, *rest)

        monkeypatch.setattr(port_layers, name, record)
    args = SpatioTemporalDETRArgs(**REPO_CONFIGS[config], enc_layers=1, dec_layers=1,
                                  dropout=0.0)
    model = build_flagship(args, device="cpu")
    batch = make_batch(np.random.default_rng(0))
    make_inference_fn(model, device="cpu")(batch)
    model.train()
    with torch.no_grad():
        model(to_device_batch(batch, torch.device("cpu")))
    assert {name for name, _, _ in pairs} == {"flash_attention", "flash_attention_train"}
    assert {(d, dv) for _, d, dv in pairs} <= set(SUPPORTED_HEAD_DIMS), pairs
    assert ("flash_attention_train", *WIDEST_PAIR[config]) in pairs, pairs


class TestFlagshipWidths:
    def test_full_width_on_a_small_clip(self):
        """The flagship's own widths (ResNet-50, D=256, 8 heads, ff 2048, 6+6
        layers, 128 queries, 8 classes) on one 64x96 clip, heads and BN
        randomized: same tolerances."""
        args = dict(num_classes=8, num_queries=128, dropout=0.0)
        rng = np.random.default_rng(1)
        model = jax_build_flagship(JaxArgs(**args))
        batch = make_batch(rng)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = randomize_heads_and_bn(
            jax.tree.map(np.asarray, model.init(jax.random.key(1), jbatch)), rng, 256, 8
        )
        ref = jax.tree.map(np.asarray, jax_make_inference_fn(model)(variables, jbatch))
        port = build_flagship(SpatioTemporalDETRArgs(**args), device="cpu")
        out = make_inference_fn(load_jax_variables(port, variables), device="cpu")(batch)
        assert out["class_scores"].shape == ref["class_scores"].shape == (1, 1, 1, 128, 9)
        np.testing.assert_allclose(out["class_scores"].numpy(), ref["class_scores"],
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], atol=BOX_ATOL)


class TestWeightBridge:
    def test_round_trip_through_reference_converter(self, jax_reference):
        variables = jax_reference[0]
        sd = jax_to_state_dict(variables, device="cpu")
        back = convert_reference_checkpoint(sd, variables, dim=TINY["hidden_dim"])
        flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_ref) == len(flat_back)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))

    def test_names_are_the_ports_state_dict(self, jax_reference):
        sd = jax_to_state_dict(jax_reference[0], device="cpu")
        model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
        own = model.state_dict()
        assert set(sd) == set(own)
        for k, v in own.items():
            assert tuple(sd[k].shape) == tuple(v.shape), k


class TestPackageRules:
    def test_port_imports_no_jax(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import future_od_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'future_od_tpu')]\n"
            "assert not bad, bad\n"
            "assert 'future_od_tpu_torch.models.build' in sys.modules\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)

    def test_entry_points_default_to_cuda(self, monkeypatch, jax_reference):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        args = SpatioTemporalDETRArgs(**TINY)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_flagship(args)
        model = build_flagship(args, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_inference_fn(model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jax_to_state_dict(jax_reference[0])
