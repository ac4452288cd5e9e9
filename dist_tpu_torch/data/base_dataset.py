"""Base video dataset (port of ``dist_tpu/data/base_dataset.py``).

Host-side dataset: annotation parsing, clip-seek video decode (the
repository's native decoder, ``data/native_decoder.py``), temporal
sampling, spatial crop, the SSV2 flip label remap, decode-retry with
neighbour fallback. ``__getitem__`` returns numpy:

    {"video": uint8 (T, S, S, 3), "label": int64, "index": int64}

Under ``PRETRAIN.ENABLE`` a train sample decodes
``NUM_CLIPS_PER_VIDEO`` distinct clips (one decoder pass) and the SSL
view generator (``ssl/generator.py``) turns them into views:

    {"video": uint8 (n, T, S, S, 3), "label", "contrastive": (n,), "index"}

Test splits replicate each video ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS``
times; ``index -> (clip_idx, spatial_idx)`` as in the JAX package, so
that the TestMeter regroups views by ``index // num_clips``. Per-sample
RNG seeds are the JAX package's formulas, so the two packages draw the
same augmentation stream.
"""

import abc
import json
import os
import zlib

import numpy as np

from dist_tpu_torch.data import rand_augment, sampling, transforms
from dist_tpu_torch.data.tokenizer import tokenize
from dist_tpu_torch.utils.logging import get_logger
from dist_tpu_torch.utils.registry import Registry

logger = get_logger(__name__)

DATASET_REGISTRY = Registry("Dataset")

# SSV2 directional classes swapped under horizontal flip
# (base_dataset.py:416-431)
SSV2_FLIP_LABEL_MAP = {86: 87, 87: 86, 93: 94, 94: 93, 166: 167, 167: 166}


def load_label_texts(cfg, anno_dir):
    """labels.json -> (class-ordered label strings, CLIP BPE tokens (C, 77)),
    with the configured prompt prefix and quotes stripped."""
    with open(os.path.join(anno_dir, "labels.json")) as f:
        lines = json.load(f)
    prompt = (cfg.DATA.DATASET_LABEL_TEXT.get("PROMPT_PREFIX", "")
              or cfg.DATA.DATASET_LABEL_TEXT.get("PROMPT", "") or "").strip()
    labels2text = {}
    for text, idx in lines.items():
        text = text.replace('"', "").strip()
        if prompt:
            text = prompt + " " + text
        labels2text[int(idx)] = text
    texts = [labels2text[i] for i in range(len(labels2text))]
    return texts, tokenize(texts)


def resolve_label_texts(cfg, num_classes):
    """-> (display names or None, CLIP tokens or None).

    Tokens only for text-classifier models (``DATASET_LABEL_TEXT.ENABLE``
    or a ``*Text*`` head); a labels.json next to the annotations supplies
    display names; a text model without one gets generic per-class
    prompts."""
    use_text = (bool(cfg.DATA.DATASET_LABEL_TEXT.ENABLE)
                or "Text" in str(cfg.VIDEO.HEAD.NAME))
    names, tokens = None, None
    anno = cfg.DATA.ANNO_DIR or ""
    if anno and os.path.exists(os.path.join(anno, "labels.json")):
        names, tokens = load_label_texts(cfg, anno)
        if not use_text:
            tokens = None
    elif use_text:
        tokens = tokenize([f"a video of class {i}"
                           for i in range(int(num_classes))])
    return names, tokens


def read_video(path, frame_indices):
    """Decode the given frame indices with the native decoder; (T,H,W,3)
    RGB uint8. Raises, saying why, where the decoder is unavailable."""
    from dist_tpu_torch.data import native_decoder
    return native_decoder.decode(path, np.asarray(frame_indices))


def probe_video(path):
    """(num_frames, fps) via the native decoder."""
    from dist_tpu_torch.data import native_decoder
    n, fps, _, _ = native_decoder.probe(path)
    return n, fps


class BaseVideoDataset(abc.ABC):
    # p=0.5 horizontal flip in the supervised train transform (the
    # kinetics-family train transforms, kinetics400.py:89); SSV2 flips
    # through the label-remap path instead, so its subclass disables this
    TRAIN_RANDOM_FLIP = True

    def __init__(self, cfg, split):
        self.cfg = cfg
        self.split = split
        self.data_root_dir = cfg.DATA.DATA_ROOT_DIR
        self.anno_dir = cfg.DATA.ANNO_DIR

        if split in ("train", "val"):
            self.dataset_name = cfg.TRAIN.DATASET
            self._num_clips = 1
        elif split in ("test", "submission"):
            self.dataset_name = cfg.TEST.DATASET
            self._num_clips = (cfg.TEST.NUM_ENSEMBLE_VIEWS
                               * cfg.TEST.NUM_SPATIAL_CROPS)
        else:
            raise NotImplementedError(f"Split {split} not supported")
        self._rand_augment = None
        self._random_erasing = None

        self._num_frames = cfg.DATA.NUM_INPUT_FRAMES
        self._sampling_rate = cfg.DATA.SAMPLING_RATE
        self._construct_dataset(cfg)

        self.text_tokens = None
        if cfg.DATA.DATASET_LABEL_TEXT.ENABLE:
            self._load_dataset_labels(cfg)

        # SSL pretraining: the view generator runs in __getitem__
        self.ssl_generator = None
        if cfg.PRETRAIN.ENABLE:
            from dist_tpu_torch.ssl.generator import build_ssl_generator
            self.ssl_generator = build_ssl_generator(cfg, split)

    # ---- to be provided by subclasses ----
    @abc.abstractmethod
    def _get_dataset_list_name(self):
        ...

    @abc.abstractmethod
    def _get_sample_info(self, index):
        ...

    def _construct_dataset(self, cfg):
        """Parse the annotation list (json, or one sample per text line).
        Test samples are replicated per view."""
        name = self._get_dataset_list_name()
        path = os.path.join(self.anno_dir, name)
        self._samples = []
        self._spatial_temporal_index = []
        if path.endswith(".json"):
            with open(path) as f:
                samples = json.load(f)
        else:
            with open(path) as f:
                samples = [line.strip() for line in f if line.strip()]
        limit = int(self.cfg.TEST.get("NUM_SAMPLES_LIMIT", -1)
                    if self.split in ("test", "submission")
                    else self.cfg.TRAIN.get("NUM_SAMPLES_LIMIT", -1))
        if limit > 0:
            samples = samples[:limit]
        for sample in samples:
            for idx in range(self._num_clips):
                self._samples.append(sample)
                self._spatial_temporal_index.append(idx)
        if not self._samples:
            raise ValueError(f"Loading at {path} failed: no samples.")
        logger.info("Dataset %s split %s: %d samples.",
                    self.dataset_name, self.split, len(self._samples))

    def _load_dataset_labels(self, cfg):
        """labels.json -> CLIP BPE tokens (C, 77)."""
        self.label_texts, self.text_tokens = load_label_texts(
            cfg, self.anno_dir)

    def __len__(self):
        return len(self._samples)

    # ---- decode ----
    def _ssl_clips(self):
        """Clips a train sample decodes for the SSL views: 1 outside
        pretraining."""
        if self.ssl_generator is None or self.split != "train":
            return 1
        return int(self.cfg.PRETRAIN.get("NUM_CLIPS_PER_VIDEO", 1))

    def _decode_video(self, sample_info, index, rng):
        """(frames, spatial_idx); for SSL pretraining's train split a list
        of ``NUM_CLIPS_PER_VIDEO`` clips, each at its own random frame
        indices, decoded in one pass over the union of the indices."""
        clip_idx, spatial_idx = self._view_indices(index)
        num_frames, fps = probe_video(sample_info["path"])
        n_clips = self._ssl_clips()
        if n_clips > 1:
            index_lists = [
                sampling.get_frame_indices(
                    self.cfg, num_frames, fps, clip_idx,
                    self.cfg.TEST.NUM_ENSEMBLE_VIEWS, rng=rng,
                    random_sample=True)
                for _ in range(n_clips)]
            frames = read_video(sample_info["path"],
                                np.concatenate(index_lists))
            bounds = np.cumsum([0] + [len(lst) for lst in index_lists])
            return [frames[a:b] for a, b in zip(bounds[:-1], bounds[1:])], \
                spatial_idx
        indices = sampling.get_frame_indices(
            self.cfg, num_frames, fps, clip_idx,
            self.cfg.TEST.NUM_ENSEMBLE_VIEWS, rng=rng,
            random_sample=(self.split == "train"))
        frames = read_video(sample_info["path"], indices)
        return frames, spatial_idx

    def _view_indices(self, index):
        """index -> (clip_idx, spatial_idx) (base_dataset.py:271-282)."""
        if self.split == "train":
            return -1, -1
        if self.split == "val":
            return -1, 0
        st = self._spatial_temporal_index[index]
        clip_idx = st // self.cfg.TEST.NUM_SPATIAL_CROPS
        if self.cfg.TEST.NUM_SPATIAL_CROPS == 1:
            spatial_idx = 0
        else:
            spatial_idx = st % self.cfg.TEST.NUM_SPATIAL_CROPS
        return clip_idx, spatial_idx

    # ---- spatial transform ----
    def _transform(self, frames, spatial_idx, rng):
        cfg = self.cfg
        if self.split != "train":
            return transforms.kinetics_resized_crop_controlled(
                frames, cfg.DATA.TEST_SCALE, cfg.DATA.TEST_CROP_SIZE,
                cfg.TEST.NUM_SPATIAL_CROPS
                if self.split in ("test", "submission") else 1,
                spatial_idx)
        # AUGMENTATION.USE_GPU moves the flip and colour jitter into the
        # step on the device; applying them here too would do them twice
        on_device = cfg.AUGMENTATION.get("USE_GPU")
        if (self.TRAIN_RANDOM_FLIP and not on_device
                and rng.uniform() < 0.5):
            # flip before crop (reference kinetics400.py:86-89)
            frames = transforms.horizontal_flip(frames)
        scales = cfg.DATA.TRAIN_JITTER_SCALES
        if scales[0] <= 1:
            frames = transforms.random_resized_crop(
                frames, cfg.DATA.TRAIN_CROP_SIZE,
                scale=scales, ratio=cfg.AUGMENTATION.RATIO, rng=rng)
        else:
            frames = transforms.kinetics_resized_crop_random(
                frames, scales, cfg.DATA.TRAIN_CROP_SIZE, rng=rng)
        if cfg.AUGMENTATION.AUTOAUGMENT.ENABLE:
            # RandAugment (or AutoAugment, AugMix) after the crop, in place
            # of the colour jitter, as the JAX package applies it
            if self._rand_augment is None:
                self._rand_augment = rand_augment.create_auto_augmentation(
                    cfg.AUGMENTATION.AUTOAUGMENT.TYPE,
                    cfg.DATA.TRAIN_CROP_SIZE)
            frames = self._rand_augment(frames, rng)
        elif cfg.AUGMENTATION.COLOR_AUG and not on_device:
            frames = transforms.color_jitter_clip(
                frames, rng,
                brightness=cfg.AUGMENTATION.BRIGHTNESS,
                contrast=cfg.AUGMENTATION.CONTRAST,
                saturation=cfg.AUGMENTATION.SATURATION,
                hue=cfg.AUGMENTATION.HUE,
                grayscale=cfg.AUGMENTATION.GRAYSCALE,
                consistent=bool(cfg.AUGMENTATION.get("CONSISTENT", True)),
                shuffle=bool(cfg.AUGMENTATION.get("SHUFFLE", True)),
                gray_first=bool(cfg.AUGMENTATION.get("GRAY_FIRST", True)),
                p=float(cfg.AUGMENTATION.get("COLOR_JITTER_P", 1.0) or 0.0))
        if cfg.AUGMENTATION.RANDOM_ERASING.ENABLE:
            if self._random_erasing is None:
                re_cfg = cfg.AUGMENTATION.RANDOM_ERASING
                self._random_erasing = rand_augment.RandomErasing(
                    prob=float(re_cfg.PROB), mode=re_cfg.MODE,
                    count=tuple(re_cfg.COUNT),
                    area_range=tuple(re_cfg.AREA_RANGE),
                    min_aspect=float(re_cfg.MIN_ASPECT))
            frames = self._random_erasing(frames, rng)
        return frames

    def _rng(self, index, seed):
        """The sample's RNG, as the JAX package seeds it: a pure function
        of (RANDOM_SEED, split, index) and the Loader's per-position
        ``seed``; without a seed, deterministic per index for eval and
        fresh entropy for train. Stable across processes: crc32 for the
        split, Python's hash of integer tuples for the rest."""
        base = hash((int(self.cfg.RANDOM_SEED),
                     zlib.crc32(self.split.encode()), int(index)))
        if seed is not None:
            base = hash((base, int(seed)))
        elif self.split == "train":
            base += int(np.random.default_rng().integers(1 << 30))
        return np.random.default_rng(base & 0x7FFFFFFF)

    def __getitem__(self, index, seed=None):
        """Decode-with-retry (a failed decode moves to the next index),
        transform, and the SSV2 flip with its label remap."""
        rng = self._rng(index, seed)
        for _ in range(2 if self.split == "train" else 10):
            try:
                sample_info = self._get_sample_info(index)
                frames, spatial_idx = self._decode_video(sample_info, index, rng)
                break
            except (OSError, ValueError) as e:
                # a bad file; an unavailable decoder (RuntimeError) is not
                # retried, since no neighbour would decode either
                logger.warning("decode failed for %d (%s); retry", index, e)
                last = e
                index = (index + 1) % len(self._samples)
        else:
            raise IOError(
                f"decode failed after retries at index {index}") from last

        label = int(sample_info["supervised_label"]) \
            if not isinstance(sample_info["supervised_label"], dict) else 0
        if self.ssl_generator is not None:
            views, labels = self.ssl_generator(
                frames if isinstance(frames, list) else [frames], {}, rng)
            return {"video": views, "label": np.int64(label),
                    "contrastive": labels["self-supervised"]["contrastive"],
                    "index": np.int64(index)}
        frames = self._transform(frames, spatial_idx, rng)

        # the label-remapping flip applies to SSV2 only (reference
        # base_dataset.py:416-431 guards on "ssv2" in the dataset name)
        if (self.split == "train" and self.cfg.AUGMENTATION.get("SSV2_FLIP")
                and "ssv2" in str(self.dataset_name).lower()
                and rng.uniform() < 0.5):
            frames = transforms.horizontal_flip(frames)
            label = SSV2_FLIP_LABEL_MAP.get(label, label)

        item = {
            "video": np.ascontiguousarray(frames),
            "label": np.int64(label),
            "index": np.int64(index),
        }
        # dual-label datasets (EPIC verb/noun) carry their extra labels in
        # the sample_info of the decode, so the neighbour fallback keeps
        # them consistent
        for key in ("verb", "noun"):
            if key in sample_info:
                item[f"label_{key}"] = np.int64(sample_info[key])
        return item
