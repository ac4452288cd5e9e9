"""Temporal-action-localization proposal post-processing (port of
``dist_tpu/tal/tools.py``; reference utils/tal_tools.py).

Array-based (no pandas dependency): proposals are dicts of numpy arrays
{"xmin", "xmax", "score", ...}.
"""

import numpy as np

from dist_tpu_torch.tal.bboxes_1d import iou_with_anchors
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def soft_nms(xmin, xmax, score, alpha, t1, t2, prop_num, iou_power=2.0):
    """Gaussian soft-NMS over 1-D proposals (utils/tal_tools.py:249-295):
    iteratively pick the max-score proposal and decay overlapping scores by
    exp(-iou^p / alpha) when iou exceeds a width-adaptive threshold.

    Returns (xmin, xmax, score, kept_indices) of the selected proposals.
    """
    xmin = np.asarray(xmin, np.float64).copy()
    xmax = np.asarray(xmax, np.float64).copy()
    score = np.asarray(score, np.float64).copy()
    index = np.arange(len(score))

    rs, re, rsc, ri = [], [], [], []
    alive = np.ones(len(score), bool)
    while alive.sum() > 1 and len(rsc) < prop_num:
        cand = np.where(alive)[0]
        best = cand[np.argmax(score[cand])]
        ious = iou_with_anchors(xmin, xmax, xmin[best], xmax[best])
        width = xmax[best] - xmin[best]
        decay_mask = alive & (ious > t1 + (t2 - t1) * width)
        decay_mask[best] = False
        score[decay_mask] *= np.exp(-np.power(ious[decay_mask], iou_power) / alpha)

        rs.append(xmin[best])
        re.append(xmax[best])
        rsc.append(score[best])
        ri.append(index[best])
        alive[best] = False
    return (np.asarray(rs), np.asarray(re), np.asarray(rsc),
            np.asarray(ri, np.int64))


def fuse_verb_noun_map(verb_vec, noun_vec, verb_topk=10, noun_topk=30,
                       top_k=20):
    """Fuse one proposal's verb/noun class scores into ranked (verb, noun)
    action pairs (reference fuse_verb_noun_map, utils/tal_tools.py:139-168):
    restrict to the top verb_topk verbs x top noun_topk nouns, outer-product
    the scores, and return the top_k pairs.

    Returns (index (top_k, 2) int [verb, noun],
             score (top_k, 3) float [verb, noun, fused])."""
    verb_vec = np.asarray(verb_vec, np.float64)
    noun_vec = np.asarray(noun_vec, np.float64)
    verb_index = np.argsort(-verb_vec)[:verb_topk]
    noun_index = np.argsort(-noun_vec)[:noun_topk]
    fuse = verb_vec[verb_index][None, :] * noun_vec[noun_index][:, None]
    # flattened over (noun, verb): row-major => idx // verb_topk is the noun
    order = np.argsort(-fuse.ravel())[:top_k]
    real_noun = noun_index[order // len(verb_index)]
    real_verb = verb_index[order % len(verb_index)]
    index = np.stack([real_verb, real_noun], axis=1)
    score = np.stack([verb_vec[real_verb], noun_vec[real_noun],
                      fuse.ravel()[order]], axis=1)
    return index, score


def fuse_verb_noun_scores(verb_scores, noun_scores, top_k=5):
    """Outer-product fusion of verb/noun proposal classifications into
    action (verb, noun) pairs (utils/tal_tools.py:139-168). Returns the
    top_k (verb_idx, noun_idx, score) triples per proposal."""
    joint = verb_scores[:, :, None] * noun_scores[:, None, :]
    n, v, c = joint.shape
    flat = joint.reshape(n, -1)
    top = np.argsort(-flat, axis=1)[:, :top_k]
    verb_idx = top // c
    noun_idx = top % c
    scores = np.take_along_axis(flat, top, axis=1)
    return verb_idx, noun_idx, scores


def _boundary_peaks(scores):
    """Boundary candidate mask: local maxima or > 0.5*max
    (utils/tal_tools.py:93-111)."""
    scores = np.asarray(scores, np.float64)
    n = len(scores)
    bins = np.zeros(n)
    mx = scores.max() if n else 0.0
    for i in range(1, n - 1):
        if scores[i] > scores[i + 1] and scores[i] > scores[i - 1]:
            bins[i] = 1
        elif scores[i] > 0.5 * mx:
            bins[i] = 1
    return bins


def parse_bmn_proposals(start_scores, end_scores, confidence_map,
                        verb_map=None, noun_map=None, top_k=20):
    """Decode BMN maps into a scored proposal list
    (reference parse_epic_bmn_proposals, utils/tal_tools.py:67-139).

    start/end_scores: (T,) boundary probabilities;
    confidence_map: (2, D, T) [regression, classification] confidences;
    verb_map/noun_map: optional (V, D, T) / (N, D, T) per-proposal class
    scores — when given, each proposal carries its fused top-k actions as
    ``vn_index`` (P, top_k, 2) and ``vn_score`` (P, top_k, 3).

    Returns dict of arrays: xmin, xmax, score (+ component scores), with
    score = start * end * cls_conf * reg_conf and boundaries restricted to
    peak/0.5-max candidates. Start bin 0 / end bin T-1 always included.
    """
    start_scores = np.asarray(start_scores, np.float64)
    end_scores = np.asarray(end_scores, np.float64)
    reg_conf = np.asarray(confidence_map[0], np.float64)
    clr_conf = np.asarray(confidence_map[1], np.float64)
    dscale, tscale = clr_conf.shape

    start_bins = _boundary_peaks(start_scores)
    start_bins[0] = 1
    end_bins = _boundary_peaks(end_scores)
    end_bins[-1] = 1

    classify = verb_map is not None and noun_map is not None
    out = {k: [] for k in ("xmin", "xmax", "xmin_score", "xmax_score",
                           "clr_score", "reg_score", "score")}
    vn_index, vn_score = [], []
    for d in range(dscale):
        for s in range(tscale):
            e = s + d + 1
            if e < tscale and start_bins[s] == 1 and end_bins[e] == 1:
                out["xmin"].append(s / tscale)
                out["xmax"].append(e / tscale)
                out["xmin_score"].append(start_scores[s])
                out["xmax_score"].append(end_scores[e])
                out["clr_score"].append(clr_conf[d, s])
                out["reg_score"].append(reg_conf[d, s])
                out["score"].append(start_scores[s] * end_scores[e]
                                    * clr_conf[d, s] * reg_conf[d, s])
                if classify:
                    idx, sc = fuse_verb_noun_map(
                        np.asarray(verb_map)[:, d, s],
                        np.asarray(noun_map)[:, d, s], top_k=top_k)
                    vn_index.append(idx)
                    vn_score.append(sc)
    props = {k: np.asarray(v) for k, v in out.items()}
    if classify:
        props["vn_index"] = np.stack(vn_index) if vn_index else \
            np.zeros((0, top_k, 2), np.int64)
        props["vn_score"] = np.stack(vn_score) if vn_score else \
            np.zeros((0, top_k, 3), np.float64)
    return props


def save_props(path, props):
    """Persist one video's proposal table (reference save_epic_props,
    utils/tal_tools.py:31-64 — torch.save of [array, heads]; a plain
    ``.npz`` of the named columns here)."""
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **props)


def load_props(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def recompute_scores(props, score_type="cr", clr_power=1.0, reg_power=1.0):
    """Ranking-score recomputation from the component scores
    (reference epic_video_post_process score_type switch,
    utils/tal_tools.py:332-343). The tca_* variants need TCA columns the
    BMN head does not produce; unknown types raise like the reference."""
    clr, reg = props["clr_score"], props["reg_score"]
    se = props["xmin_score"] * props["xmax_score"]
    if score_type == "cr":
        score = np.power(clr, clr_power) * np.power(reg, reg_power)
    elif score_type == "se":
        score = se
    elif score_type == "secr":
        score = clr * reg * se
    else:
        raise ValueError(f"unknown score_type: {score_type}")
    out = dict(props)
    out["score"] = score
    return out


def video_post_process(props, duration, select_score=0.001,
                       score_type="cr", clr_power=1.0, reg_power=1.0,
                       snms_alpha=0.4, snms_t1=0.25, snms_t2=0.7,
                       prop_num_ratio=3.0, iou_power=2.0,
                       action_topk=5, action_score_power=1.0,
                       action_key="label"):
    """One video's proposals -> detection list (reference
    epic_video_post_process, utils/tal_tools.py:298-372): recompute the
    ranking score, drop low scores, soft-NMS with a duration-adaptive
    proposal budget, then expand each surviving proposal into its top-k
    fused (verb, noun) actions. Returns the reference's detection-JSON
    entries: {"score", action_key: "v,n", "verb", "noun", "segment"}."""
    props = recompute_scores(props, score_type, clr_power, reg_power)
    keep = props["score"] > select_score
    props = {k: v[keep] for k, v in props.items()}
    prop_num = int(duration / prop_num_ratio) + 1
    if len(props["score"]) > 1:
        xmin, xmax, score, kept = soft_nms(
            props["xmin"], props["xmax"], props["score"],
            snms_alpha, snms_t1, snms_t2, prop_num, iou_power)
    else:
        xmin, xmax, score = props["xmin"], props["xmax"], props["score"]
        kept = np.arange(len(score))
    order = np.argsort(-score)
    detections = []
    has_vn = "vn_index" in props and len(props["vn_index"])
    for j in order[:prop_num]:
        seg = [float(max(0.0, xmin[j]) * duration),
               float(min(1.0, xmax[j]) * duration)]
        if not has_vn:
            detections.append({"score": float(score[j]), "segment": seg})
            continue
        vn = props["vn_index"][kept[j]]
        vs = props["vn_score"][kept[j]]
        for k in range(min(action_topk, len(vn))):
            v, n = int(vn[k, 0]), int(vn[k, 1])
            detections.append({
                "score": float(score[j]
                               * np.power(vs[k, 2], action_score_power)),
                action_key: f"{v},{n}",
                "verb": v,
                "noun": n,
                "segment": seg,
            })
    return detections


def _post_process_cfg(cfg):
    """POST_PROCESS knobs with the reference's EPIC defaults; every key is
    optional (the reference ships no TAL config either)."""
    pp = (cfg.LOCALIZATION.get("POST_PROCESS") or {}) if cfg else {}
    get = pp.get if hasattr(pp, "get") else lambda k, d: d
    return dict(
        select_score=float(get("SELECT_SCORE", 0.001) or 0.001),
        score_type=str(get("SCORE_TYPE", "cr") or "cr"),
        clr_power=float(get("CLR_POWER", 1.0) or 1.0),
        reg_power=float(get("REG_POWER", 1.0) or 1.0),
        snms_alpha=float(get("SOFT_NMS_ALPHA", 0.4) or 0.4),
        snms_t1=float(get("SOFT_NMS_LOW_THRES", 0.25) or 0.25),
        snms_t2=float(get("SOFT_NMS_HIGH_THRES", 0.7) or 0.7),
        prop_num_ratio=float(get("PROP_NUM_RATIO", 3.0) or 3.0),
        iou_power=float(get("IOU_POWER", 2.0) or 2.0),
        action_score_power=float(get("ACTION_SCORE_POWER", 1.0) or 1.0),
    )


def localization_post_processing(cfg, video_props, out_path=None,
                                 action_key="label", num_workers=None):
    """The detection driver (reference proposals_post_processing +
    epic_localization_post_processing, utils/tal_tools.py:170-246):
    post-process every video's proposals in parallel and assemble the
    EPIC-style detection results JSON.

    video_props: {video_name: (props_dict, duration_seconds)}.
    Returns the results dict; when ``out_path`` is given also writes the
    JSON file and returns its path alongside (dict, path)."""
    from concurrent.futures import ThreadPoolExecutor

    knobs = _post_process_cfg(cfg)
    if num_workers is None:
        pp = (cfg.LOCALIZATION.get("POST_PROCESS") or {}) if cfg else {}
        num_workers = int(pp.get("THREAD", 8) or 8) if hasattr(pp, "get") else 8

    def one(item):
        name, (props, duration) = item
        return name, video_post_process(props, duration,
                                        action_key=action_key, **knobs)

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        results = dict(pool.map(one, video_props.items()))

    output = {
        "version": "0.2",
        "challenge": "action_detection",
        "sls_pt": 2,
        "sls_tl": 3,
        "sls_td": 3,
        "results": results,
    }
    if out_path is None:
        return output
    import json
    import os
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(output, f, indent=2)
    logger.info("Detection results written to %s", out_path)
    return output, out_path
