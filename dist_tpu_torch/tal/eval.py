"""Temporal action detection evaluation (port of
``dist_tpu/tal/eval.py``): interpolated mAP at tIoU thresholds
(reference utils/eval_tal/eval_epic_detection.py:17-374 and
eval_tal.py:12-23; the standard ActivityNet detection protocol).

Ground truth / predictions are plain dicts:
    gt:   {video_id: [{"t_start", "t_end", "label"}, ...]}
    pred: {video_id: [{"t_start", "t_end", "label", "score"}, ...]}
"""

import numpy as np

from dist_tpu_torch.tal.bboxes_1d import iou_with_anchors
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def interpolated_ap(precision, recall):
    """All-point interpolated AP (ActivityNet style)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def _ap_for_class(gt_by_video, preds, tiou):
    """preds: list of (video_id, t_start, t_end, score), sorted by score."""
    npos = sum(len(v) for v in gt_by_video.values())
    if npos == 0:
        return np.nan
    matched = {vid: np.zeros(len(segs), bool) for vid, segs in gt_by_video.items()}
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    for i, (vid, ts, te, _) in enumerate(preds):
        segs = gt_by_video.get(vid)
        if not segs:
            fp[i] = 1
            continue
        starts = np.asarray([s[0] for s in segs])
        ends = np.asarray([s[1] for s in segs])
        ious = iou_with_anchors(starts, ends, ts, te)
        # ActivityNet protocol: walk candidates by descending IoU and take
        # the best UNMATCHED ground truth above the threshold (matching
        # only the argmax would count a prediction FP when its argmax GT
        # is taken but another overlapping GT still qualifies)
        hit = False
        for j in np.argsort(ious)[::-1]:
            if ious[j] < tiou:
                break
            if not matched[vid][j]:
                tp[i] = 1
                matched[vid][j] = True
                hit = True
                break
        if not hit:
            fp[i] = 1
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / npos
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-8)
    return interpolated_ap(precision, recall)


def evaluate_detection(ground_truth, predictions,
                       tiou_thresholds=np.linspace(0.5, 0.95, 10)):
    """mAP over classes and tIoU thresholds
    (reference eval_tal.py:12-23). Returns {"mAP": float,
    "mAP_per_tiou": [...], "tiou_thresholds": [...]}."""
    labels = set()
    for segs in ground_truth.values():
        labels.update(s["label"] for s in segs)

    gt_by_label = {lab: {} for lab in labels}
    for vid, segs in ground_truth.items():
        for s in segs:
            gt_by_label[s["label"]].setdefault(vid, []).append(
                (s["t_start"], s["t_end"]))

    pred_by_label = {lab: [] for lab in labels}
    for vid, segs in predictions.items():
        for s in segs:
            if s["label"] in pred_by_label:
                pred_by_label[s["label"]].append(
                    (vid, s["t_start"], s["t_end"], s["score"]))
    for lab in pred_by_label:
        pred_by_label[lab].sort(key=lambda x: -x[3])

    ap = np.zeros((len(tiou_thresholds), len(labels)))
    for li, lab in enumerate(sorted(labels)):
        for ti, tiou in enumerate(tiou_thresholds):
            ap[ti, li] = _ap_for_class(gt_by_label[lab], pred_by_label[lab], tiou)

    map_per_tiou = np.nanmean(ap, axis=1)
    result = {
        "mAP": float(np.nanmean(map_per_tiou)),
        "mAP_per_tiou": [float(x) for x in map_per_tiou],
        "tiou_thresholds": [float(t) for t in tiou_thresholds],
    }
    logger.info("Detection mAP: %.4f (per-tIoU: %s)", result["mAP"],
                ["%.3f" % x for x in map_per_tiou])
    return result


class EpicDetection:
    """EPIC-KITCHENS grouped detection evaluation (reference
    utils/eval_tal/eval_epic_detection.py:17-374, ``Epicdetection``):
    per-class detection AP over tIoU thresholds, reported three ways —
    grouped by action label ("verb,noun" strings), by verb id, and by noun
    id. ``assign_class`` restricts the action evaluation to one label
    (the reference's debugging filter, eval_epic_detection.py:34-36,196).

    Ground truth: ActivityNet-style JSON —
      {"database": {vid: {"subset": ..., "annotations":
          [{"segment": [s, e], "label": "verb,noun"}]}}}
    Predictions: the detection results JSON written by
    ``tal.tools.localization_post_processing`` —
      {"results": {vid: [{"segment": [s, e], "label": "verb,noun",
                          "verb": v, "noun": n, "score": p}]}}
    """

    def __init__(self, ground_truth_filename, prediction_filename,
                 tiou_thresholds=np.linspace(0.5, 0.95, 10),
                 subset="validation", assign_class=None, verbose=False):
        import json

        self.tiou_thresholds = np.asarray(tiou_thresholds, np.float64)
        self.subset = subset
        self.assign_class = assign_class
        self.verbose = verbose

        with open(ground_truth_filename) as f:
            data = json.load(f)
        if "database" not in data:
            raise IOError("Please input a valid ground truth file.")
        # activity_index assigns class ids in first-seen order
        # (eval_epic_detection.py:84-113); verb/noun ids come from the
        # "verb,noun" label strings
        self.activity_index = {}
        self.gt = []            # (vid, t_start, t_end, label_id, verb, noun)
        self.verb_labels = {}
        self.noun_labels = {}
        for vid, v in data["database"].items():
            if v.get("subset", subset) != self.subset:
                continue
            for ann in v["annotations"]:
                lab = ann["label"]
                if lab not in self.activity_index:
                    self.activity_index[lab] = len(self.activity_index)
                verb, noun = (int(x) for x in lab.split(","))
                self.verb_labels.setdefault(verb, len(self.verb_labels))
                self.noun_labels.setdefault(noun, len(self.noun_labels))
                self.gt.append((vid, float(ann["segment"][0]),
                                float(ann["segment"][1]),
                                self.activity_index[lab], verb, noun))

        with open(prediction_filename) as f:
            data = json.load(f)
        if "results" not in data:
            raise IOError("Please input a valid prediction file.")
        self.pred = []
        for vid, v in data["results"].items():
            for r in v:
                lab = r.get("label", r.get("action"))
                if lab not in self.activity_index:
                    # unseen-class predictions are dropped, like the
                    # reference (eval_epic_detection.py:153-154)
                    continue
                verb, noun = (int(x) for x in lab.split(","))
                self.pred.append((vid, float(r["segment"][0]),
                                  float(r["segment"][1]),
                                  self.activity_index[lab],
                                  int(r.get("verb", verb)),
                                  int(r.get("noun", noun)),
                                  float(r["score"])))
        if self.verbose:
            logger.info("[INIT] %d GT instances, %d predictions, subset=%s",
                        len(self.gt), len(self.pred), self.subset)

    def _ap_matrix(self, group_of_gt, group_of_pred, group_ids):
        """AP per (tIoU, group) for an arbitrary grouping key."""
        gt_by_group = {g: {} for g in group_ids}
        for (vid, ts, te, *_), g in zip(self.gt, map(group_of_gt, self.gt)):
            if g in gt_by_group:  # assign_class restricts the group set
                gt_by_group[g].setdefault(vid, []).append((ts, te))
        pred_by_group = {g: [] for g in group_ids}
        for p in self.pred:
            g = group_of_pred(p)
            if g in pred_by_group:
                pred_by_group[g].append((p[0], p[1], p[2], p[6]))
        for g in pred_by_group:
            pred_by_group[g].sort(key=lambda x: -x[3])
        ap = np.zeros((len(self.tiou_thresholds), len(group_ids)))
        for gi, g in enumerate(group_ids):
            for ti, tiou in enumerate(self.tiou_thresholds):
                ap[ti, gi] = _ap_for_class(gt_by_group[g], pred_by_group[g],
                                           tiou)
        return ap

    def evaluate(self):
        """Returns {"action": ..., "verb": ..., "noun": ...} with mAP,
        per-tIoU mAP, and the per-group AP matrix for each grouping
        (reference evaluate(), eval_epic_detection.py:231-242; the verbose
        per-tIoU line mirrors print_map, 244-254)."""
        groupings = {
            "action": (lambda r: r[3], lambda p: p[3],
                       list(self.activity_index.values())),
            "verb": (lambda r: r[4], lambda p: p[4],
                     list(self.verb_labels.keys())),
            "noun": (lambda r: r[5], lambda p: p[5],
                     list(self.noun_labels.keys())),
        }
        if self.assign_class is not None:
            cidx = self.activity_index[self.assign_class]
            groupings = {"action": (lambda r: r[3], lambda p: p[3], [cidx])}
        out = {}
        for name, (gof, pof, ids) in groupings.items():
            ap = self._ap_matrix(gof, pof, ids)
            map_per_tiou = np.nanmean(ap, axis=1) if ap.size else \
                np.zeros(len(self.tiou_thresholds))
            out[name] = {
                "mAP": float(np.nanmean(map_per_tiou)),
                "mAP_per_tiou": [float(x) for x in map_per_tiou],
                "ap": ap,
            }
            logger.info("%s mAP: %.4f (%s)", name, out[name]["mAP"],
                        ", ".join("%.2f:%.4f" % (t, m) for t, m in
                                  zip(self.tiou_thresholds, map_per_tiou)))
        return out


def evaluate_detection_files(video_anno_file, detection_result_file,
                             tiou_thresholds=np.linspace(0.5, 0.95, 10)):
    """File-based entry matching the reference API
    (utils/eval_tal/eval_tal.py:12-23). Annotation: ActivityNet-style
    ``{"database": {vid: {"annotations": [{"segment": [s, e],
    "label": l}]}}}`` (or a flat {vid: [...]} mapping); results:
    ``{"results": {vid: [{"segment": [s, e], "label": l, "score": p}]}}``."""
    import json

    with open(video_anno_file) as f:
        anno = json.load(f)
    db = anno.get("database", anno)
    gt = {}
    for vid, entry in db.items():
        segs = entry["annotations"] if isinstance(entry, dict) else entry
        gt[vid] = [{"t_start": s["segment"][0], "t_end": s["segment"][1],
                    "label": s["label"]} for s in segs]

    with open(detection_result_file) as f:
        res = json.load(f)
    res = res.get("results", res)
    pred = {}
    for vid, segs in res.items():
        pred[vid] = [{"t_start": s["segment"][0], "t_end": s["segment"][1],
                      "label": s["label"], "score": s["score"]} for s in segs]
    return evaluate_detection(gt, pred, tiou_thresholds)
