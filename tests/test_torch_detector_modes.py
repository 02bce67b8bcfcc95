"""The detector's modes in the port against the JAX package on the CPU:
slotstates, "attend all at once", each first_layer_special_when ("always"
is the flagship's), the attention-capturing flagship and its captured
weights against flax's `intermediates` path for path, packed projections
(FUTURE_OD_PACKED_PROJ=1), and the A/B gates FUTURE_OD_NO_DEC_SKIP and
FUTURE_OD_STACKED_HEADS. Tiny models, JAX variables and tolerances as in
tests/test_torch_variants.py, whose helpers this file uses. About 40 s
alone.
"""
import jax
import numpy as np
import pytest
import torch

from future_od_tpu.models import build as jax_build

from future_od_tpu_torch.models import build
from future_od_tpu_torch.models.st_detr import captured_attention
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_variants import (
    TINY,
    assert_outputs_match,
    batch_tensors,
    check_tree,
    check_variant,
    jax_detector_model,
    jnp_batch,
    port_detector_model,
    variant_fixture,
)

# the captured weights: softmax rows in f32, measured within 1e-7
WEIGHT_ATOL = 1e-6


def modes(**mode):
    return lambda a, p: (jax_detector_model(a, **mode), port_detector_model(p, **mode))


VARIANTS = {
    "slotstates": modes(use_slotstates=True),
    "attend all at once": modes(image_memory_mode="attend all at once"),
    "first frame": modes(first_layer_special_when="first frame"),
    "first frame slotstates": modes(first_layer_special_when="first frame", use_slotstates=True),
    "never": modes(first_layer_special_when="never"),
    "capturing flagship": lambda a, p: (jax_build.build_flagship(a, store_attention=True),
                                        build.build_flagship(p, device="cpu",
                                                             store_attention=True)),
}
variants = variant_fixture(VARIANTS)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_equals_jax(variants, name):
    check_variant(variants, name)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_parameter_tree_is_the_jax_tree(variants, name):
    check_tree(variants, name)


def test_trees_without_jax_parameters_hold_no_module(variants):
    """"attend all at once" has one image attention; a first layer that is
    never special has no query_pos projection, and under "first frame"
    only the current frame's attention has one, and only with slotstates
    (without them the first frame's pass is skipped)."""
    once = variants("attend all at once")[0].state_dict()
    assert not any("image_attend.1" in k for k in once)
    layer0 = "_model.detector.decoder.layers.0.image_attend"
    for name, have in (("never", []), ("first frame", []), ("first frame slotstates", [0]),
                       ("slotstates", [0, 1])):
        sd = variants(name)[0].state_dict()
        assert [j for j in (0, 1) if f"{layer0}.{j}.query_pos.weight" in sd] == have, name
    assert any("slotstates_attend" in k for k in variants("slotstates")[0].state_dict())


def test_captured_attention_equals_intermediates(variants):
    port, jmodel, variables, batch = variants("capturing flagship")
    _, state = jmodel.apply(variables, jnp_batch(batch), deterministic=True,
                            mutable=["intermediates"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path[:-1]): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["intermediates"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    with torch.no_grad():
        port(batch_tensors(batch))
    captured = captured_attention(port)
    assert sorted(captured) == sorted(flat) and len(captured) == 2 * TINY["dec_layers"]
    assert "core/detector/decoder/layer0/image_attend1" in captured
    for path, weights in captured.items():
        assert len(weights) == len(flat[path]) == 1, path
        np.testing.assert_allclose(weights[0].numpy(), np.asarray(flat[path][0]),
                                   atol=WEIGHT_ATOL, err_msg=path)
        np.testing.assert_allclose(weights[0].sum(-1).numpy(), 1.0, atol=1e-6)
    with torch.no_grad():  # a second forward drops the first one's weights
        port(batch_tensors(batch))
    assert all(len(w) == 1 for w in captured_attention(port).values())


def test_capture_takes_the_plain_path(variants, monkeypatch):
    """A capturing attention never goes to the flash kernel, whatever the
    gate says (the JAX gate is use_flash and not sow_weights)."""
    from future_od_tpu_torch.models import layers

    port, _, _, batch = variants("capturing flagship")
    calls = []

    def counting(q, k, v, scale):
        calls.append(q.shape[2])
        return torch.zeros(q.shape[:3] + (v.shape[-1],))
    monkeypatch.setattr(layers, "flash_attention", counting)
    monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
    monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
    with torch.no_grad():
        port(batch_tensors(batch))
    # the encoder's self-attentions over 8 tokens, never the decoder's 5 queries
    assert calls == [8] * TINY["enc_layers"]


@pytest.mark.parametrize("name", ["capturing flagship", "slotstates"])
def test_packed_projections_equal_unpacked_and_jax(variants, name, monkeypatch):
    port, jmodel, variables, batch = variants(name)
    with torch.no_grad():
        unpacked = port(batch_tensors(batch))
    monkeypatch.setenv("FUTURE_OD_PACKED_PROJ", "1")
    with torch.no_grad():
        packed = port(batch_tensors(batch))
    ref = jax.tree.map(np.asarray, jmodel.apply(variables, jnp_batch(batch), deterministic=True))
    assert_outputs_match(packed, ref)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(packed[key].numpy(), unpacked[key].numpy(), atol=1e-6)


@pytest.mark.parametrize("gate", ["FUTURE_OD_NO_DEC_SKIP", "FUTURE_OD_STACKED_HEADS"])
def test_ab_gates_change_nothing(variants, gate, monkeypatch):
    """The JAX package's A/B gates: running the dead decoder passes, and the
    heads over the stacked levels, give the same outputs and aux levels."""
    port, _, _, batch = variants("first frame")
    with torch.no_grad():
        plain = port(batch_tensors(batch), aux_levels=True)
    monkeypatch.setenv(gate, "1")
    with torch.no_grad():
        gated = port(batch_tensors(batch), aux_levels=True)
    for key in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(gated[key], plain[key], rtol=0, atol=1e-6)
    assert len(gated["aux_outputs"]) == len(plain["aux_outputs"]) == TINY["dec_layers"] - 1
    for a, b in zip(gated["aux_outputs"], plain["aux_outputs"]):
        torch.testing.assert_close(a["pred_logits"], b["pred_logits"], rtol=0, atol=1e-6)
