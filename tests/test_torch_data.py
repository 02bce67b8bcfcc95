"""The port's data path against the JAX package, on the CPU: synthetic
samples and `collate` bit for bit, the Loader's batch order (shuffled over
epochs, the validation seed, a ragged last batch, host space-to-depth), and
the PNG that `visualize` writes, decoded, pixel for pixel. About 3 s alone.
"""
import cv2  # decodes the PNGs here; the port never imports it
import numpy as np
import pytest

from future_od_tpu.data import loader as jax_loader
from future_od_tpu.data.synthetic import SyntheticClipDataset as JaxSyntheticClipDataset
from future_od_tpu.ops.target_utils import construct_box_targets as jax_construct_box_targets
from future_od_tpu.utils.visualization import visualize as jax_visualize

from future_od_tpu_torch.data import loader
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.ops.target_utils import construct_box_targets
from future_od_tpu_torch.utils.visualization import visualize, write_png


def assert_same_sample(a, b):
    assert list(a) == list(b)
    for key, value in b.items():
        if isinstance(value, (np.ndarray, np.generic)):
            assert np.asarray(a[key]).dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(a[key], value, err_msg=key)
        else:
            assert a[key] == value, key


@pytest.mark.parametrize("kw", [
    dict(seed=1, image_size=(64, 96), max_objects=3),
    dict(seed=2, image_size=(128, 192)),
    dict(seed=0, image_size=(48, 80), num_frames=1, temporal_offsets=(0.0,)),
    dict(seed=7, image_size=(64, 64), num_frames=2, num_classes=4, max_num_objects=4),
])
def test_synthetic_samples_equal_jax(kw):
    ours, ref = SyntheticClipDataset(num_samples=8, **kw), JaxSyntheticClipDataset(
        num_samples=8, **kw)
    assert len(ours) == len(ref)
    for idx in (0, 3, 7):
        assert_same_sample(ours[idx], ref[idx])


def test_construct_box_targets_equals_jax(rng):
    boxes = rng.uniform(0, 50, size=(7, 4)).astype(np.float32)
    classes = rng.integers(0, 5, size=7)
    for ignore in (None, {2, 4}):
        for n in (4, 10):
            for o, r in zip(construct_box_targets(boxes, classes, n, ignore),
                            jax_construct_box_targets(boxes, classes, n, ignore)):
                assert o.dtype == r.dtype
                np.testing.assert_array_equal(o, r)


def test_collate_equals_jax():
    ds = SyntheticClipDataset(num_samples=3, image_size=(40, 48))
    samples = [ds[i] for i in range(3)]
    assert_same_sample(loader.collate(samples), jax_loader.collate(samples))


@pytest.mark.parametrize("case", [
    dict(batch_size=3, shuffle=True, seed=5),
    dict(batch_size=3, shuffle=True, seed=5, drop_last=False),
    dict(batch_size=2, shuffle=False, seed=loader.VAL_SEED, drop_last=False),
    dict(batch_size=4, shuffle=False, seed=loader.VAL_SEED, drop_last=False, space_to_depth=True),
])
def test_loader_order_equals_jax(case):
    """Two epochs (set_epoch 1, 2) of 7 clips: the same batches in the same
    order, the last one ragged where drop_last is off."""
    ds = SyntheticClipDataset(num_samples=7, image_size=(40, 48), max_objects=2)
    ours = loader.Loader(ds, num_workers=3, **case)
    ref = jax_loader.Loader(ds, num_workers=3, device_put=False, **case)
    assert len(ours) == len(ref)
    epochs = []
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert_same_sample(a, b)
        epochs.append([b["idf"] for b in got])
    if case["shuffle"]:
        assert epochs[0] != epochs[1]
    if not case.get("drop_last", True):
        assert len(got[-1]["idf"]) == (7 % case["batch_size"] or case["batch_size"])
    if case.get("space_to_depth"):
        assert got[0]["video"].shape[-3:] == (20, 24, 12)


def test_loader_stops_early_and_raises_worker_errors():
    ds = SyntheticClipDataset(num_samples=20, image_size=(40, 48))
    for batch in loader.Loader(ds, batch_size=2, num_workers=2, prefetch=1):
        break  # the producer drains and stops with the consumer

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(loader.Loader(Broken(), batch_size=2, num_workers=2))


def test_visualize_png_equals_jax(tmp_path, rng):
    """Predictions (a score matrix, thresholded) and annotations (labels
    with the background) drawn on one normalized frame: the decoded PNGs
    equal the JAX package's (cv2) pixel for pixel."""
    image = rng.normal(size=(40, 64, 3)).astype(np.float32)
    boxes = np.array([[2, 3, 20, 30], [10, 5, 60, 38], [-5, -5, 100, 100]], np.float32)
    cases = {
        "pred": rng.uniform(size=(3, 4)).astype(np.float32),
        "anno": np.array([0, 4, 2]),
    }
    for name, classes in cases.items():
        ours, ref = tmp_path / f"{name}.png", tmp_path / f"{name}_jax.png"
        out = visualize(image, classes, boxes, str(ours), background_class=4)
        want = jax_visualize(image, classes, boxes, str(ref), background_class=4)
        np.testing.assert_array_equal(out, want)
        decoded = cv2.imread(str(ours), cv2.IMREAD_UNCHANGED)
        assert decoded is not None and decoded.shape == (40, 64, 3)
        np.testing.assert_array_equal(decoded, cv2.imread(str(ref), cv2.IMREAD_UNCHANGED))


def test_write_png_round_trip(tmp_path, rng):
    rgb = rng.integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    write_png(str(tmp_path / "x.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "x.png"))[..., ::-1], rgb)
