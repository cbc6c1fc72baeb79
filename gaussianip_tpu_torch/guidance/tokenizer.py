"""The CLIP byte-level BPE tokenizer (what the JAX package gets from
transformers' CLIPTokenizer, gaussianip_tpu/system/pipeline.py:99-114),
from a tokenizer directory's vocab.json and merges.txt, with
special_tokens_map.json / tokenizer_config.json where present.

It reproduces CLIPTokenizer as it runs without `ftfy`: transformers'
BasicTokenizer(strip_accents=False, do_split_on_punc=False) clean-up
(control characters dropped, whitespace runs to one space, CJK characters
spaced out, NFC, lower case), the pre-tokenizer pattern
  <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+
(case-insensitive), the byte-to-unicode map and the ranked merges. The
pattern is written for the standard library's `re`: `\\p{L}` and `\\p{N}`
become explicit character classes of every code point whose Unicode
category (`unicodedata`) starts with L or N, so the classes are exact up
to the difference between Python's Unicode version and the `regex`
package's. Calls pad to `max_length` with the pad token and truncate
the text's tokens, keeping BOS and EOS.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# transformers keeps the first 49152 - 256 - 2 merges of merges.txt
MAX_MERGES = 49152 - 256 - 2


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _ranges(pred) -> str:
    """A character class body of the code points where `pred(category)`."""
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and pred(unicodedata.category(chr(cp)))
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            a, b = re.escape(chr(start)), re.escape(chr(cp - 1))
            out.append(a if start == cp - 1 else f"{a}-{b}")
            start = None
    return "".join(out)


@lru_cache(maxsize=None)
def pretokenizer() -> re.Pattern:
    letters = _ranges(lambda c: c[0] == "L")
    numbers = _ranges(lambda c: c[0] == "N")
    return re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        rf"[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+", re.IGNORECASE)


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) joined by spaces: control characters and
    U+0000 / U+FFFD dropped, whitespace to spaces, CJK characters spaced
    out, NFC, whitespace split, lower case."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch)[0] == "C":
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split())


def _special(d: dict, key: str, default: str) -> str:
    v = d.get(key, default)
    return v.get("content", default) if isinstance(v, dict) else v


class CLIPTokenizer:
    def __init__(self, vocab: dict, merges: list, bos: str = BOS,
                 eos: str = EOS, pad: str = EOS, unk: str = EOS):
        self.encoder = vocab
        self.ranks = {tuple(m.split()): i
                      for i, m in enumerate(merges[:MAX_MERGES])}
        self.byte_encoder = bytes_to_unicode()
        self.bos, self.eos, self.pad, self.unk = bos, eos, pad, unk
        self.cache = {BOS: BOS, EOS: EOS}

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str) -> "CLIPTokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"),
                  encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:]
        special = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(tokenizer_dir, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    special.update(json.load(f))
        return cls(vocab, merges, _special(special, "bos_token", BOS),
                   _special(special, "eos_token", EOS),
                   _special(special, "pad_token", EOS),
                   _special(special, "unk_token", EOS))

    def bpe(self, token: str) -> list:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            new, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = " ".join(word)
        return list(word)

    def tokenize(self, text: str) -> list:
        """Text -> BPE tokens. Special tokens in the text stay whole, as
        transformers splits on its added tokens first."""
        out = []
        for part in re.split(f"({re.escape(BOS)}|{re.escape(EOS)})", text):
            if part in (BOS, EOS):
                out.append(part)
                continue
            for tok in pretokenizer().findall(basic_clean(part)):
                out.extend(self.bpe("".join(self.byte_encoder[b]
                                            for b in tok.encode("utf-8"))))
        return out

    def encode(self, text: str, max_length: int = 77) -> list:
        unk = self.encoder.get(self.unk)
        ids = [self.encoder.get(t, unk) for t in self.tokenize(text)]
        ids = ids[:max_length - 2]
        ids = [self.encoder[self.bos]] + ids + [self.encoder[self.eos]]
        return ids + [self.encoder[self.pad]] * (max_length - len(ids))

    def __call__(self, prompts, max_length: int = 77) -> np.ndarray:
        """list of prompts -> input ids [N, max_length] int64 (padded with
        the pad token, truncated keeping BOS and EOS)."""
        return np.array([self.encode(p, max_length) for p in prompts],
                        np.int64)
