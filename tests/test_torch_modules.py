"""Each ported module against its JAX counterpart, on numpy-seeded inputs.

The module weights come from one tiny JAX flagship (test_torch_flagship.py:
ResNet-50, D=32, 4 heads, ff 48, 2+2 layers), bridged into the port by
utils/jax_weights.py; each JAX submodule is applied with its own subtree of
those variables, each port submodule is the matching attribute of the port
flagship. Everything runs in f32 on the CPU.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from future_od_tpu.models.decoder import TransformerDecoder as JaxDecoder
from future_od_tpu.models.encoder import TransformerEncoder as JaxEncoder
from future_od_tpu.models.layers import EgodeepAttention as JaxEgodeep
from future_od_tpu.models.layers import EncoderAttention as JaxEncoderAttention
from future_od_tpu.models.layers import SlotToImageAttention as JaxSlotToImage
from future_od_tpu.models.layers import SlotToSlotAttention as JaxSlotToSlot
from future_od_tpu.models.resnet import CDetrBackbone as JaxBackbone
from future_od_tpu.models.resnet import device_normalize as jax_device_normalize
from future_od_tpu.models.st_detr import post_process as jax_post_process
from future_od_tpu.ops import posenc as jax_posenc
from future_od_tpu.ops.misc import inverse_sigmoid as jax_inverse_sigmoid
from future_od_tpu.ops.misc import video_hw as jax_video_hw

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.resnet import device_normalize
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs, post_process
from future_od_tpu_torch.ops import posenc
from future_od_tpu_torch.ops.misc import inverse_sigmoid, video_hw
from future_od_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_flagship import TINY, tiny_jax_flagship

D, HEADS, FF = TINY["hidden_dim"], TINY["nheads"], TINY["dim_feedforward"]
# f32 on both sides; products and LayerNorms reassociated
ATOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    """(JAX params, JAX frozen, port flagship on the CPU with those weights)."""
    _, variables, _ = tiny_jax_flagship()
    port = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
    load_jax_variables(port, variables)
    return variables["params"]["core"], variables["frozen"]["core"], port._model


def arrays(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def run_torch(module, *inputs, **kwargs):
    with torch.no_grad():
        conv = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a  # noqa: E731
        return module(*[conv(a) for a in inputs], **{k: conv(v) for k, v in kwargs.items()})


def run_jax(module, variables, *inputs, **kwargs):
    conv = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    return module.apply(
        variables, *[conv(a) for a in inputs], **{k: conv(v) for k, v in kwargs.items()}
    )


def close(out, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


class TestPosencAndMisc:
    @pytest.mark.parametrize("h,w,c", [(5, 7, 32), (28, 50, 256)])
    def test_spatial_encoding(self, h, w, c):
        close(posenc.spatial_encoding(h, w, c), jax_posenc.spatial_encoding(h, w, c))

    def test_spatio_temporal_encoding(self, rng):
        close(
            posenc.spatio_temporal_encoding(2, 3, 4, 16, no_temporal=True),
            jax_posenc.spatio_temporal_encoding(2, 3, 4, 16, no_temporal=True),
        )
        close(
            posenc.spatio_temporal_encoding(3, 3, 4, 16),
            jax_posenc.spatio_temporal_encoding(3, 3, 4, 16),
        )
        offs = np.array([[-1.0, -0.5, 0.0], [-0.9, -0.4, 0.1]], np.float32)
        close(
            posenc.spatio_temporal_encoding(
                3, 3, 4, 16, temporal_offsets=torch.from_numpy(offs), extra_temporal_offset=0.5
            ),
            jax_posenc.spatio_temporal_encoding(
                3, 3, 4, 16, temporal_offsets=jnp.asarray(offs), extra_temporal_offset=0.5
            ),
            atol=1e-4,  # sin/cos of arguments up to 4π
        )

    def test_temporal_encoding_goldens(self):
        # tests/test_ops.py::TestTemporalEncodingGolden, on the port
        enc = posenc.temporal_encoding(2, 8, temporal_offsets=torch.tensor([[-1.0, -0.5]]))
        assert enc.shape == (1, 2, 8)
        np.testing.assert_allclose(enc[0, :, 0], [np.sin(4 * np.pi), np.sin(2 * np.pi)], atol=1e-4)
        np.testing.assert_allclose(enc[0, :, 1], [1.0, 1.0], atol=1e-4)
        t = np.array([4 * np.pi, 2 * np.pi])
        np.testing.assert_allclose(enc[0, :, 2], np.sin(t / 10000.0 ** (2.0 / 8)), atol=1e-4)
        enc = posenc.temporal_encoding(3, 4)
        np.testing.assert_allclose(
            enc[:, 0], np.sin(np.arange(1, 4) / (3 + 1e-6) * 2 * np.pi), atol=1e-5
        )

    def test_gen_sineembed_for_position(self, rng):
        pos = rng.uniform(size=(2, 5, 2)).astype(np.float32)
        close(
            posenc.gen_sineembed_for_position(torch.from_numpy(pos), 32),
            jax_posenc.gen_sineembed_for_position(jnp.asarray(pos), 32),
        )

    def test_inverse_sigmoid_and_video_hw(self, rng):
        x = np.concatenate([rng.uniform(size=20), [0.0, 1.0, -0.5, 1.5, 1e-7]]).astype(np.float32)
        close(inverse_sigmoid(torch.from_numpy(x)), jax_inverse_sigmoid(jnp.asarray(x)), atol=1e-5)
        for c in (3, 12, 48):
            v = np.zeros((1, 2, 4, 6, c), np.float32)
            assert video_hw(torch.from_numpy(v)) == jax_video_hw(v)

    def test_post_process(self, rng):
        logits, boxes = arrays(rng, (2, 1, 5, 4), (2, 1, 5, 4))
        boxes = 1 / (1 + np.exp(-boxes))
        video = np.zeros((2, 3, 64, 96, 3), np.float32)
        out, scores, anno = post_process(
            torch.from_numpy(logits), torch.from_numpy(boxes), {"video": torch.from_numpy(video)}
        )
        ref, ref_scores, ref_anno = jax_post_process(
            jnp.asarray(logits), jnp.asarray(boxes), {"video": jnp.asarray(video)}
        )
        for k in ("class_scores", "boxes"):
            close(out[k], ref[k], atol=1e-4)
        close(scores, ref_scores)
        close(anno, ref_anno, atol=1e-4)


class TestLayers:
    def test_slot_to_slot_attention(self, bridged, rng):
        params, _, port = bridged
        qc, qp, kc, kp = arrays(rng, (2, 5, D), (2, 5, D), (2, 7, D), (2, 7, D))
        ref = run_jax(JaxSlotToSlot(D, HEADS, 0.0),
                      {"params": params["detector"]["decoder"]["layer0"]["self_attend"]},
                      qc, qp, kc, kp)
        close(run_torch(port.detector.decoder.layers[0].self_attend, qc, qp, kc, kp), ref)

    @pytest.mark.parametrize("layer", [0, 1])
    @pytest.mark.parametrize("flash_gate", ["default", "lowered"])
    def test_slot_to_image_attention(self, bridged, rng, monkeypatch, layer, flash_gate):
        if flash_gate == "lowered":  # through the flash wrapper (plain on the CPU)
            monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
            monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
        params, _, port = bridged
        qc, qp, qs, kc, ks = arrays(rng, (2, 5, D), (2, 5, D), (2, 5, D), (2, 11, D), (2, 11, D))
        first = layer == 0
        ref = run_jax(
            JaxSlotToImage(D, HEADS, 0.0, use_query_pos=first),
            {"params": params["detector"]["decoder"][f"layer{layer}"]["image_attend1"]},
            qc, qp if first else None, qs, kc, first, ks,
        )
        mod = port.detector.decoder.layers[layer].image_attend[1]
        close(run_torch(mod, qc, qp if first else None, qs, kc, first, ks), ref)

    @pytest.mark.parametrize("where", ["encoder", "decoder"])
    def test_egodeep_attention(self, bridged, rng, where):
        params, _, port = bridged
        x, pos, ego = arrays(rng, (2, 9, D), (1, 9, D), (2, 1, D))
        if where == "encoder":  # with the norm/mlp block and its out + dropout(out) quirk
            jax_mod = JaxEgodeep(D, HEADS, 0.0, ff_dim=FF)
            p = params["separate_encoder"]["transformer"]["layer1"]["egodeep_attend"]
            mod = port.separate_encoder.transformer.layers[1].egodeep_attend
        else:
            jax_mod = JaxEgodeep(D, HEADS, 0.0)
            p = params["detector"]["decoder"]["layer1"]["egodeep_attend"]
            mod = port.detector.decoder.layers[1].egodeep_attend
        close(run_torch(mod, x, pos, ego), run_jax(jax_mod, {"params": p}, x, pos, ego))

    @pytest.mark.parametrize("flash_gate", ["default", "lowered"])
    def test_encoder_attention(self, bridged, rng, monkeypatch, flash_gate):
        if flash_gate == "lowered":
            monkeypatch.setenv("FUTURE_OD_FLASH_MIN_KEYS", "1")
            monkeypatch.setenv("FUTURE_OD_FLASH_MIN_QUERIES", "1")
        params, _, port = bridged
        src, pos = arrays(rng, (2, 12, D), (1, 12, D))
        qk = src + pos
        ref = run_jax(
            JaxEncoderAttention(D, HEADS, FF, 0.0),
            {"params": params["separate_encoder"]["transformer"]["layer0"]["self_attn"]},
            src, qk, qk, src,
        )
        mod = port.separate_encoder.transformer.layers[0].self_attn
        close(run_torch(mod, src, qk, qk, src), ref)


class TestStacks:
    def test_encoder(self, bridged, rng):
        params, _, port = bridged
        tokens, pos, ego = arrays(rng, (2, 12, D), (1, 12, D), (2, 1, D))
        ref = run_jax(
            JaxEncoder(2, D, HEADS, FF, 0.0, use_egodeep=True),
            {"params": params["separate_encoder"]["transformer"]},
            tokens, image_pos=pos, egodeep=ego,
        )
        close(run_torch(port.separate_encoder.transformer, tokens, pos, ego), ref, atol=2e-5)

    @pytest.mark.parametrize("first_layer_special", [True, False])
    def test_decoder(self, bridged, rng, first_layer_special):
        params, _, port = bridged
        qc, qp, img0, img1, pos, ego = arrays(
            rng, (2, 5, D), (2, 5, D), (2, 11, D), (2, 11, D), (2, 11, D), (2, 1, D)
        )
        hs_ref, refpts_ref = run_jax(
            JaxDecoder(2, D, HEADS, FF, 0.0, num_images=2, use_egodeep=True),
            {"params": params["detector"]["decoder"]},
            qc, qp, [jnp.asarray(img0), jnp.asarray(img1)], [jnp.asarray(pos)] * 2,
            first_layer_special=first_layer_special, egodeep=ego,
        )
        t = torch.from_numpy
        hs, refpts = run_torch(
            port.detector.decoder, qc, qp, [t(img0), t(img1)], [t(pos)] * 2,
            first_layer_special=first_layer_special, egodeep=ego,
        )
        close(hs, hs_ref, atol=2e-5)
        close(refpts, refpts_ref)


class TestBackbone:
    @pytest.mark.parametrize("gates", ["plain", "fused"])
    def test_backbone(self, bridged, rng, monkeypatch, gates):
        if gates == "fused":  # BN folding + weight layouts of the fused kernels' wrappers
            monkeypatch.setenv("FUTURE_OD_FUSED_RESNET", "1")
            monkeypatch.setenv("FUTURE_OD_FUSED_STEM", "1")
        params, frozen, port = bridged
        (x,) = arrays(rng, (2, 64, 96, 3))
        ref = np.asarray(run_jax(
            JaxBackbone(D),
            {"params": params["separate_encoder"]["backbone"],
             "frozen": frozen["separate_encoder"]["backbone"]},
            x,
        ))
        out = run_torch(port.separate_encoder.backbone, x)
        assert out.shape == ref.shape == (2, 2, 3, D)
        # 53 convolutions of reassociated f32 sums, relative to the output scale
        close(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-5)

    def test_uint8_device_normalize(self, rng):
        x = rng.integers(0, 256, size=(1, 4, 6, 12)).astype(np.uint8)
        close(
            device_normalize(torch.from_numpy(x), torch.float32),
            jax_device_normalize(jnp.asarray(x), jnp.float32),
            atol=1e-6,
        )
