"""SSL view generators (port of ``dist_tpu/ssl/generator.py``).

``ContrastiveGenerator``: per sample, ``NUM_CLIPS_PER_VIDEO`` views, each
from its own decoded clip where the dataset gives several (else the one
clip again), each independently cropped (random resized crop), flipped
and, on the host path, colour-jittered, blurred and turned grey; labels
``{"self-supervised": {"contrastive": arange(n)}}``. Under
``AUGMENTATION.USE_GPU`` the photometric ops run in the train step on the
device instead (``ops/augment_device.py``) and the views leave here as
crops and flips of the decoded uint8 frames. The draws follow the JAX
package's order on the sample's numpy ``rng``, so both packages make the
same views.
"""

import numpy as np

from dist_tpu_torch.data import transforms
from dist_tpu_torch.utils.registry import Registry

SSL_GENERATOR_REGISTRY = Registry("SSLGenerator")

_RGB2GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def build_ssl_generator(cfg, split):
    generator = SSL_GENERATOR_REGISTRY.get_strict(cfg.PRETRAIN.GENERATOR)
    return generator(cfg, split)


@SSL_GENERATOR_REGISTRY.register()
class ContrastiveGenerator:
    def __init__(self, cfg, split):
        self.cfg = cfg
        self.split = split
        self.num_views = int(cfg.PRETRAIN.get("NUM_CLIPS_PER_VIDEO", 2))
        self.crop_size = int(cfg.DATA.TRAIN_CROP_SIZE)

    def _crop_scale(self):
        """The random resized crop's area range from
        ``TRAIN_JITTER_SCALES`` as the reference computes it (``s^2 / 256 /
        340``: simclr's [168, 224] -> (0.324, 0.576))."""
        s0, s1 = self.cfg.DATA.TRAIN_JITTER_SCALES
        return (s0 * s0 / 256.0 / 340.0, s1 * s1 / 256.0 / 340.0)

    def __call__(self, frames_list, labels, rng):
        """``frames_list``: decoded uint8 clips (T, H, W, 3), one a view or
        one for all. Returns (views (n, T, S, S, 3) uint8, labels with
        "self-supervised"). Each view: crop -> (host path: jitter gated by
        ``AUGMENTATION.COLOR`` -> blur with probability ``BLUR`` ->
        grayscale with probability ``GRAYSCALE``) -> flip."""
        aug = self.cfg.AUGMENTATION
        use_gpu = bool(aug.get("USE_GPU"))
        views = []
        for i in range(self.num_views):
            frames = frames_list[i % len(frames_list)]
            v = transforms.random_resized_crop(
                frames, self.crop_size, scale=self._crop_scale(),
                ratio=tuple(aug.RATIO), rng=rng)
            if not use_gpu:
                v = transforms.color_jitter_clip(
                    v, rng, brightness=aug.BRIGHTNESS, contrast=aug.CONTRAST,
                    saturation=aug.SATURATION, hue=aug.HUE,
                    grayscale=0.0,  # applied after the blur, below
                    consistent=bool(aug.get("CONSISTENT", True)),
                    shuffle=bool(aug.get("SHUFFLE", True)),
                    p=float(aug.get("COLOR", 0.8) or 0.0))
                blur_p = float(aug.get("BLUR", 0.0) or 0.0)
                if blur_p > 0 and rng.uniform() < blur_p:
                    v = transforms.gaussian_blur_clip(v, rng)
                gray_p = float(aug.GRAYSCALE or 0.0)
                if gray_p > 0 and rng.uniform() < gray_p:
                    g = v.astype(np.float32) @ _RGB2GRAY
                    v = np.repeat(g[..., None], 3, axis=-1).astype(np.uint8)
            if rng.uniform() < 0.5:
                v = transforms.horizontal_flip(v)
            views.append(np.ascontiguousarray(v))
        labels = dict(labels)
        labels["self-supervised"] = {
            "contrastive": np.arange(self.num_views, dtype=np.int64)}
        return np.stack(views), labels
