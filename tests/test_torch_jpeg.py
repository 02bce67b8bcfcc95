"""The port's JPEG decoder and resizes (`data/image.py` over
`csrc/jpeg_decode.cpp`, built with g++ at first use) against OpenCV, which
the JAX package decodes and resizes with.

- decode: bit for bit against cv2.imread (+ BGR->RGB) over 4:4:4, 4:2:2,
  4:2:0 and grayscale, qualities 50/75/95, odd sizes and restart
  intervals; progressive and non-JPEG files raise ValueError naming the
  file;
- resize: cv2.resize(INTER_LINEAR) bit for bit on uint8 (cv2's 11-bit fixed
  point); on float32 within F32_ATOL (measured 2.4e-7 on normalized frames,
  whose scale is 2.6: cv2's float path rounds its products in another
  order);
- the committed fixtures (`future_od_tpu_torch/data/fixtures/`, 1600x900
  frames that chip_smoke phase 7 decodes on the card): re-encoded here from
  their seeds they give the committed bytes, and cv2 decodes them to the
  manifest's pixel digests, which the port's decoder must reproduce.

Regenerate the fixtures (needs OpenCV), from the repo root:
`PYTHONPATH=. python tests/test_torch_jpeg.py --write`. About 3 s alone.
"""
import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest

from future_od_tpu_torch.data.image import decode_jpeg, read_image_rgb, resize_linear

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "future_od_tpu_torch", "data", "fixtures")
# name: (seed, sampling, quality, restart interval in MCUs)
FIXTURES = {
    "frame0_420_q90.jpg": (0, "420", 90, 0),
    "frame1_420_q75_rst4.jpg": (1, "420", 75, 4),
    "frame2_444_q85.jpg": (2, "444", 85, 0),
}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
F32_ATOL = 5e-7


def fixture_image(seed, H=900, W=1600):
    """A street-scene-like BGR frame from a seed: smooth colour fields,
    mid-scale texture, sensor noise and a dozen flat boxes with edges."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.uniform(0, 255, (9, 16, 3)).astype(np.float32), (W, H),
                      interpolation=cv2.INTER_CUBIC)
    mid = cv2.resize(rng.normal(0, 40, (90, 160, 3)).astype(np.float32), (W, H),
                     interpolation=cv2.INTER_LINEAR)
    img = base + mid + rng.normal(0, 2, (H, W, 3)).astype(np.float32)
    for _ in range(12):
        y, x = rng.integers(0, H - 100), rng.integers(0, W - 160)
        h, w = rng.integers(30, 100), rng.integers(40, 160)
        img[y:y + h, x:x + w] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img, sampling, quality, restart=0, progressive=False):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def sample_image(seed, H, W, gray=False):
    """Smooth colour with 10 % noisy pixels: every coefficient range occurs."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img = np.where(rng.uniform(size=(H, W, 1)) < 0.1, base, cv2.GaussianBlur(base, (0, 0), 3))
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("size", [(16, 16), (17, 13), (33, 50), (9, 161)])
def test_decode_equals_cv2(size, sampling, quality):
    for restart in (0, 3):
        data = encode(sample_image(sum(size) + quality, *size), sampling, quality, restart)
        assert (b"\xff\xdd" in data) == bool(restart)  # the DRI marker is there
        np.testing.assert_array_equal(decode_jpeg(data), cv2_rgb(data),
                                      err_msg=f"restart {restart}")


@pytest.mark.parametrize("quality", [50, 95])
def test_decode_grayscale_equals_cv2(quality):
    data = encode(sample_image(5, 31, 47, gray=True), "444", quality)
    out = decode_jpeg(data)
    np.testing.assert_array_equal(out, cv2_rgb(data))
    assert (out[..., 0] == out[..., 2]).all()


def test_unreadable_files_raise_naming_the_file(tmp_path):
    data = encode(sample_image(1, 32, 32), "420", 75, progressive=True)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="progressive.jpg: a progressive JPEG"):
        read_image_rgb(str(path))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n" + bytes(64), "x.png")
    with pytest.raises(FileNotFoundError):
        read_image_rgb(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("src,dst", [((900, 1600), (448, 800)), ((90, 160), (64, 128)),
                                     ((37, 53), (80, 120)), ((64, 96), (32, 48)),
                                     ((33, 47), (33, 20))])
def test_resize_equals_cv2(src, dst):
    """uint8 bit for bit; float32 (normalized frames) within F32_ATOL."""
    img = cv2.GaussianBlur(sample_image(3, *src), (0, 0), 1.5)
    rgb = img[..., ::-1]
    np.testing.assert_array_equal(resize_linear(rgb, dst),
                                  cv2.resize(np.ascontiguousarray(rgb), dst[::-1],
                                             interpolation=cv2.INTER_LINEAR))
    norm = ((rgb.astype(np.float32) / 255.0 - np.array([0.485, 0.456, 0.406], np.float32))
            / np.array([0.229, 0.224, 0.225], np.float32)).astype(np.float32)
    ours = resize_linear(norm, dst)
    theirs = cv2.resize(norm, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=F32_ATOL)


def manifest():
    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_reencodes_and_decodes_to_its_digest(name):
    seed, sampling, quality, restart = FIXTURES[name]
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        data = f.read()
    assert encode(fixture_image(seed), sampling, quality, restart) == data
    entry = manifest()[name]
    assert sha256(data) == entry["file_sha256"]
    assert sha256(cv2_rgb(data).tobytes()) == entry["pixels_sha256"]
    out = read_image_rgb(os.path.join(FIXTURE_DIR, name))
    assert out.shape == (900, 1600, 3) and sha256(out.tobytes()) == entry["pixels_sha256"]


def test_fixtures_stay_small():
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in FIXTURES) <= 1_000_000


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    entries = {}
    for name, (seed, sampling, quality, restart) in sorted(FIXTURES.items()):
        data = encode(fixture_image(seed), sampling, quality, restart)
        with open(os.path.join(FIXTURE_DIR, name), "wb") as f:
            f.write(data)
        entries[name] = {"seed": seed, "sampling": sampling, "quality": quality,
                         "restart_interval": restart, "file_sha256": sha256(data),
                         "pixels_sha256": sha256(cv2_rgb(data).tobytes())}
    with open(os.path.join(FIXTURE_DIR, "manifest.json"), "w") as f:
        json.dump(entries, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__" and "--write" in sys.argv:
    write_fixtures()
