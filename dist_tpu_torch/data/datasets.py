"""Concrete datasets (port of ``dist_tpu/data/datasets.py``).

All register into ``DATASET_REGISTRY``; names resolve via
``capitalize()`` as in the JAX package's builder. ``Synthetic`` makes
deterministic random videos (no data files), the same videos as the JAX
package's for the same index."""

import os

import numpy as np

from dist_tpu_torch.data.base_dataset import BaseVideoDataset, DATASET_REGISTRY
from dist_tpu_torch.data.tokenizer import tokenize


@DATASET_REGISTRY.register()
class Ssv2(BaseVideoDataset):
    """Something-Something-V2 (reference dataset/base/ssv2.py:32-152)."""

    # SSV2 flips only through the label-remap path (temporal direction
    # matters); the reference ssv2 train transform has no flip.
    TRAIN_RANDOM_FLIP = False

    def _get_dataset_list_name(self):
        return "something-something-v2-{}-with-label.json".format(
            "train" if self.split == "train" else "validation")

    def _get_sample_info(self, index):
        s = self._samples[index]
        return {
            "path": os.path.join(self.data_root_dir, s["id"] + ".mp4"),
            "supervised_label": int(s["label_idx"]),
        }


class _CsvListDataset(BaseVideoDataset):
    """Datasets whose lists are ``relpath label`` text lines
    (kinetics400.py:33-203, ucf101/hmdb51)."""

    def _get_sample_info(self, index):
        line = self._samples[index]
        parts = line.replace(",", " ").split()
        path, label = parts[0], int(parts[-1])
        return {
            "path": os.path.join(self.data_root_dir, path),
            "supervised_label": label,
        }


@DATASET_REGISTRY.register()
class Kinetics400(_CsvListDataset):
    def _get_dataset_list_name(self):
        return f"kinetics400_{self.split if self.split != 'submission' else 'test'}_list.txt"


@DATASET_REGISTRY.register()
class Kinetics700(_CsvListDataset):
    def _get_dataset_list_name(self):
        return f"kinetics700_{self.split}_list.txt"


@DATASET_REGISTRY.register()
class Ucf101(_CsvListDataset):
    def _get_dataset_list_name(self):
        return f"ucf101_{'train' if self.split == 'train' else 'test'}_list.txt"


@DATASET_REGISTRY.register()
class Hmdb51(_CsvListDataset):
    def _get_dataset_list_name(self):
        return f"hmdb51_{'train' if self.split == 'train' else 'test'}_list.txt"


@DATASET_REGISTRY.register()
class Synthetic(BaseVideoDataset):
    """Deterministic random-video dataset for tests and benchmarks; runs
    the whole view-replication, sampling and transform path without
    touching disk. Frames are made at the largest configured size, so
    the test path's resize is a no-op."""

    NUM_SYNTH = 32
    TRAIN_RANDOM_FLIP = False  # keep synthetic batches deterministic

    def _construct_dataset(self, cfg):
        n = int(cfg.TRAIN.get("NUM_SAMPLES_LIMIT", -1))
        if self.split in ("test", "submission"):
            n = int(cfg.TEST.get("NUM_SAMPLES_LIMIT", -1))
        n = n if n > 0 else self.NUM_SYNTH
        self._samples = []
        self._spatial_temporal_index = []
        for i in range(n):
            for idx in range(self._num_clips):
                self._samples.append(i)
                self._spatial_temporal_index.append(idx)

    def _get_dataset_list_name(self):
        return ""

    def _get_sample_info(self, index):
        vid = self._samples[index]
        nc = self.cfg.VIDEO.HEAD.NUM_CLASSES
        if isinstance(nc, (list, tuple)):
            # dual-head (EPIC verb/noun) configs: synthesize both labels
            return {"path": f"synthetic://{vid}",
                    "supervised_label": vid % int(nc[0]),
                    "verb": vid % int(nc[0]), "noun": vid % int(nc[1])}
        return {"path": f"synthetic://{vid}",
                "supervised_label": vid % int(nc or 10)}

    def _decode_video(self, sample_info, index, rng):
        """The video's seeded frames; for SSL pretraining's train split
        ``NUM_CLIPS_PER_VIDEO`` distinct clips, clip ``i`` seeded by
        ``hash((vid, i))``, as the JAX package's."""
        _, spatial_idx = self._view_indices(index)
        vid = int(sample_info["path"].split("//")[1])
        size = max(self.cfg.DATA.TRAIN_CROP_SIZE, self.cfg.DATA.TEST_CROP_SIZE,
                   self.cfg.DATA.TEST_SCALE)

        def clip(seed):
            return np.random.default_rng(seed).integers(
                0, 256, (self._num_frames, size, size, 3), dtype=np.uint8)

        n_clips = self._ssl_clips()
        if n_clips > 1:
            return [clip(hash((vid, i)) & 0x7FFFFFFF)
                    for i in range(n_clips)], spatial_idx
        return clip(vid), spatial_idx

    def _load_dataset_labels(self, cfg):
        nc = cfg.VIDEO.HEAD.NUM_CLASSES
        if isinstance(nc, (list, tuple)):
            return  # dual-head configs don't use the CLIP label-text path
        n = int(nc or 10)
        self.text_tokens = tokenize([f"synthetic class {i}" for i in range(n)])


@DATASET_REGISTRY.register()
class Epickitchen100(BaseVideoDataset):
    """EPIC-KITCHENS-100 with verb/noun dual labels. List format:
    ``relpath verb_id noun_id`` per line
    (``epickitchen100_{split}_list.txt``)."""

    def _get_dataset_list_name(self):
        split = "train" if self.split == "train" else "test"
        return f"epickitchen100_{split}_list.txt"

    def _get_sample_info(self, index):
        parts = self._samples[index].replace(",", " ").split()
        path, verb, noun = parts[0], int(parts[1]), int(parts[2])
        return {
            "path": os.path.join(self.data_root_dir, path),
            "supervised_label": verb,  # primary label slot
            # picked up as label_verb/label_noun by the base __getitem__
            "verb": verb,
            "noun": noun,
        }
