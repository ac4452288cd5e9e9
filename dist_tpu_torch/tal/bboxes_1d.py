"""1-D (temporal) box overlap utilities (port of
``dist_tpu/tal/bboxes_1d.py``; reference utils/bboxes_1d.py)."""

import numpy as np


def ioa_with_anchors(anchors_min, anchors_max, box_min, box_max):
    """Intersection over anchor length (utils/bboxes_1d.py:4-21)."""
    len_anchors = anchors_max - anchors_min
    inter = np.maximum(
        np.minimum(anchors_max, box_max) - np.maximum(anchors_min, box_min), 0.0)
    return np.divide(inter, np.maximum(len_anchors, 1e-8))


def iou_with_anchors(anchors_min, anchors_max, box_min, box_max):
    """Temporal IoU (utils/bboxes_1d.py:24-40)."""
    len_anchors = anchors_max - anchors_min
    inter = np.maximum(
        np.minimum(anchors_max, box_max) - np.maximum(anchors_min, box_min), 0.0)
    union = len_anchors - inter + box_max - box_min
    return np.divide(inter, np.maximum(union, 1e-8))
