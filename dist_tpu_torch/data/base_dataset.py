"""Label texts for the text classifier (port of ``load_label_texts`` and
``resolve_label_texts`` of ``dist_tpu/data/base_dataset.py``).

The dataset classes and their video decoding come with the eval run-list
slice."""

import json
import os

from dist_tpu_torch.data.tokenizer import tokenize


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
