"""The port's JPEG writer (``utils/jpeg.py``) against ``cv2.imencode('.jpg',
a)`` at OpenCV's defaults (libjpeg-turbo, quality 95), on the CPU: the
same bytes, and so the same decoded pixels, for 1 x 1, 8 x 8, 13 x 17, a
constant image, seeded noise and smooth images of awkward sizes, a
batch coded together, and a feature-map image of the JAX package's
rendering. The test imports ``cv2``; the port does not."""

import numpy as np
import pytest
import torch

from dist_tpu.utils.visualization import feature_map_image
from dist_tpu_torch.utils import jpeg

cv2 = pytest.importorskip("cv2")

# the segments OpenCV writes, in order (SOI, APP0, DQT, SOF0, DHT DC, DHT
# AC, SOS, then the entropy-coded data and EOI)
MARKERS = [0xD8, 0xE0, 0xDB, 0xC0, 0xC4, 0xC4, 0xDA]


def _images():
    rng = np.random.default_rng(0)
    smooth = np.add.outer(np.arange(37) * 3, np.arange(29) * 5) % 256
    fmap = feature_map_image(rng.standard_normal((1, 4, 7, 9, 6)))[0]
    return {
        "1x1": np.full((1, 1), 77, np.uint8),
        "8x8": rng.integers(0, 256, (8, 8), dtype=np.uint8),
        "13x17": rng.integers(0, 256, (13, 17), dtype=np.uint8),
        "constant": np.full((23, 31), 200, np.uint8),
        "black": np.zeros((9, 9), np.uint8),
        "white": np.full((16, 24), 255, np.uint8),
        "smooth": smooth.astype(np.uint8),
        "noise_tall": rng.integers(0, 256, (130, 3), dtype=np.uint8),
        "gauss": (rng.standard_normal((61, 45)) * 40 + 128).clip(
            0, 255).astype(np.uint8),
        "feature_map": fmap,
    }


IMAGES = _images()


def _segments(data):
    """The markers before the entropy-coded data, in order, and where
    that data starts."""
    out, i = [], 2
    assert data[:2] == b"\xff\xd8"
    markers = [0xD8]
    while True:
        assert data[i] == 0xFF
        marker, size = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        markers.append(marker)
        out.append(data[i:i + 2 + size])
        i += 2 + size
        if marker == 0xDA:
            return markers, i


def _first_difference(got, want):
    """The segment of the first byte that differs, by name."""
    names = ["SOI", "APP0", "DQT", "SOF0", "DHT DC", "DHT AC", "SOS"]
    ends, i = [], 2
    for _ in names[1:]:
        ends.append(i)
        i += 2 + int.from_bytes(want[i + 2:i + 4], "big")
    first = next((k for k in range(min(len(got), len(want)))
                  if got[k] != want[k]), min(len(got), len(want)))
    bounds = [0] + ends + [i]
    for name, lo, hi in zip(names, bounds, bounds[1:]):
        if lo <= first < hi:
            return name
    return "entropy-coded data" if first < len(want) - 2 else "EOI"


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_bytes_and_pixels_equal_opencv(name):
    a = IMAGES[name]
    want = cv2.imencode(".jpg", a)[1].tobytes()
    got = jpeg.encode(a[None])[0]
    assert _segments(got)[0] == MARKERS
    assert got == want, _first_difference(got, want)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_UNCHANGED),
        cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_UNCHANGED))


def test_13x17_noise_from_a_tensor():
    """A seeded 13 x 17 noise array given as a tensor: OpenCV's 628 bytes,
    APP0, one DQT, SOF0, two DHT and SOS before the data."""
    a = np.random.default_rng(0).integers(0, 256, (13, 17), dtype=np.uint8)
    want = cv2.imencode(".jpg", a)[1].tobytes()
    assert len(want) == 628
    assert jpeg.encode(torch.from_numpy(a)[None])[0] == want
    assert _segments(want)[0] == MARKERS


def test_a_batch_is_coded_as_its_images():
    """Images coded together give each image's own file (each its own DC
    predictor, byte-aligned and padded)."""
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (5, 19, 26), dtype=np.uint8)
    batch[2] = 255           # 0xFF bytes: stuffing
    got = jpeg.encode(torch.from_numpy(batch))
    assert [g == cv2.imencode(".jpg", b)[1].tobytes()
            for g, b in zip(got, batch)] == [True] * 5


def test_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(np.zeros((1, 4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(np.zeros((4, 4), np.uint8))
