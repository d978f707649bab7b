"""CLIP's byte-pair-encoding tokenizer in plain Python (counterpart of
vggt_slam_tpu/models/clip_tokenizer.py), reading `vocab.json` and
`merges.txt`.

  1. basic clean: control characters dropped, whitespace normalized, NFC,
     CJK spaced out, lowercased (transformers' path without ftfy).
  2. CLIP's pattern
         <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
         |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+      (case-insensitive)
     by a scanner on `unicodedata.category` (`split`): Python's `re` has no
     \\p classes, and no `regex` package is needed.
  3. GPT-2's byte -> unicode table, BPE with `</w>` on each word's end.
  4. BOS ... EOS, cut to the context and right-padded with EOS.
"""
from __future__ import annotations

import functools
import json
import os
import unicodedata

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# \s of the pattern: Unicode White_Space, which is str.isspace less the
# four information separators U+001C-U+001F
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")
# U+0345 (a mark) case-folds to a letter, so under the pattern's IGNORECASE
# no alternative matches it, as no alternative matches white space
_UNMATCHED = "\u0345"


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte -> printable-unicode-char table."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_clean(text: str) -> str:
    """BasicTokenizer(strip_accents=False, do_split_on_punc=False) +
    lowercase + single-space join, as transformers' no-ftfy fallback."""
    out = []
    for ch in text:
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
        elif ord(ch) in (0, 0xFFFD) or unicodedata.category(ch).startswith("C"):
            continue  # control chars (other than the whitespace trio above)
        elif unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in out)
    text = unicodedata.normalize("NFC", text)
    return " ".join(t.lower() for t in text.strip().split())


def _kind(ch: str) -> str:
    """"L", "N", "s" (matched by no alternative: white space) or "p"
    (anything else)."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    if ch == _UNMATCHED or ch.isspace() and ch not in _NOT_WHITE_SPACE:
        return "s"
    return "p"


def _fold(ch: str) -> str:
    """The pattern's case-insensitive match on its ASCII letters: simple
    case folding, under which U+017F (long s) is "s"."""
    return "s" if ch == "ſ" else ch.lower() if ch.isascii() else ch


def _literal_at(text: str, i: int, lit: str) -> bool:
    return len(text) - i >= len(lit) and all(
        _fold(c) == p for c, p in zip(text[i:i + len(lit)], lit))


def split(text: str) -> list[str]:
    """What CLIP's pattern finds in `text`, left to right: at each position
    the first alternative that matches (the specials, the contractions, a
    run of letters, one number, a run of neither space, letter nor number);
    white space matches none and is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS
                    if _literal_at(text, i, s)), None)
        kind = _kind(text[i])
        if lit is not None:
            j = i + len(lit)
        elif kind == "s":
            i += 1
            continue
        elif kind == "N":
            j = i + 1
        else:
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    def __init__(self, vocab_file: str, merges_file: str,
                 context_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            # line 0 is the "#version" header; the released file also has
            # trailing unused merges past the vocab-derived count.
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.context_length = context_length
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.unk_id = self.eos_id
        self._cache: dict[str, str] = {}

    @classmethod
    def from_dir(cls, model_dir: str, context_length: int = 77):
        return cls(os.path.join(model_dir, "vocab.json"),
                   os.path.join(model_dir, "merges.txt"), context_length)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for tok in split(basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self._bpe(tok).split(" "))
        return tokens

    def encode(self, text: str) -> list[int]:
        """bos + bpe ids + eos, truncated to the context length."""
        ids = [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[:self.context_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def __call__(self, texts: list[str] | str) -> np.ndarray:
        """(N, context_length) int64 ids, right-padded with EOS."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.eos_id,
                      dtype=np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, :len(ids)] = ids
        return out
