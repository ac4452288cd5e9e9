"""CLIP BPE tokenizer (port of ``dist_tpu/data/tokenizer.py``).

Byte-level BPE with the public ``assets/bpe_simple_vocab_16e6.txt.gz``
merges (read in place), lowercasing and whitespace cleanup,
``<|startoftext|>``/``<|endoftext|>`` framing and a 77-token context.

The JAX package splits words with the third-party ``regex`` module's
``\\p{L}`` / ``\\p{N}`` classes; the port uses the standard ``re`` module,
with ``[^\\W\\d_]+`` for a run of letters, ``\\d`` for a digit and
``(?:[^\\s\\w]|_)+`` for a run of other symbols. The two agree on ASCII and
on letters and decimal digits of every script. They differ on numeric
characters that are not decimal digits (Unicode categories Nl and No,
such as "²", "½" or "Ⅻ"): the reference makes each a one-character
number token, the port joins them to a neighbouring run of letters.
"""

import functools
import gzip
import html
import os
import re

import numpy as np

CONTEXT_LENGTH = 77

VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "assets", "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text):
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path=VOCAB_PATH):
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE)

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text):
        bpe_tokens = []
        for token in re.findall(self.pat, _clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


@functools.lru_cache()
def _default_tokenizer():
    return SimpleTokenizer(VOCAB_PATH)


def tokenize(texts, context_length=CONTEXT_LENGTH):
    """texts -> int64 (N, context_length), sot/eot framed, truncated."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        tokens = [sot] + tok.encode(text)[:context_length - 2] + [eot]
        out[i, :len(tokens)] = tokens
    return out
