"""SigLIP's SentencePiece unigram tokenizer in plain Python (counterpart of
vggt_slam_tpu/models/siglip_tokenizer.py), reading a checkpoint
directory's `spiece.model` without the sentencepiece package.

  1. the pieces of sentencepiece_model.proto's `ModelProto.pieces` (field 1:
     {piece: string = 1, score: float = 2, type: enum = 3}), in id order;
  2. SiglipTokenizer's text: ASCII punctuation stripped, whitespace
     collapsed, then NFKC; spaces become "▁", with one leading;
  3. Viterbi segmentation by the sum of piece scores; a character no piece
     covers is `<unk>` at min(NORMAL scores) - 10;
  4. eos appended after at most L - 1 ids, right-padded with eos to the
     full context (the text tower pools the last position).
"""
from __future__ import annotations

import os
import string
import struct
import unicodedata

import numpy as np

SPIECE_UNDERLINE = "▁"
_PUNCT = str.maketrans("", "", string.punctuation)


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    x = shift = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, i
        shift += 7


def _skip(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        return _varint(buf, i)[1]
    if wire == 2:
        n, i = _varint(buf, i)
        return i + n
    if wire in (1, 5):
        return i + (8 if wire == 1 else 4)
    raise ValueError(f"bad wire type {wire}")


def parse_spiece_model(data: bytes) -> list[tuple[str, float, int]]:
    """A `spiece.model` protobuf -> [(piece, score, type)] in id order; type
    1 NORMAL, 2 UNKNOWN, 3 CONTROL, 4 USER_DEFINED, 5 UNUSED, 6 BYTE."""
    pieces = []
    i = 0
    while i < len(data):
        key, i = _varint(data, i)
        if key != 0x0A:                  # not field 1, wire 2: skip it
            i = _skip(data, i, key & 7)
            continue
        n, i = _varint(data, i)
        end, piece, score, ptype = i + n, "", 0.0, 1
        while i < end:
            k, i = _varint(data, i)
            if k == 0x0A:
                n, i = _varint(data, i)
                piece, i = data[i:i + n].decode("utf-8"), i + n
            elif k == 0x15:
                score, i = struct.unpack_from("<f", data, i)[0], i + 4
            elif k == 0x18:
                ptype, i = _varint(data, i)
            else:
                i = _skip(data, i, k & 7)
        pieces.append((piece, score, ptype))
    return pieces


def write_spiece_model(pieces: list[tuple[str, float, int]]) -> bytes:
    """[(piece, score, type)] -> the proto subset `parse_spiece_model`
    reads (a vocabulary without the sentencepiece package)."""
    def varint(x: int) -> bytes:
        out = bytearray()
        while x >= 0x80:
            out.append((x & 0x7F) | 0x80)
            x >>= 7
        return bytes(out + bytes([x]))

    out = bytearray()
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        body = (b"\x0a" + varint(len(pb)) + pb + b"\x15"
                + struct.pack("<f", score) + b"\x18" + varint(ptype))
        out += b"\x0a" + varint(len(body)) + body
    return bytes(out)


class SigLIPTokenizer:
    """`__call__(texts)` -> (N, context_length) int64 ids."""

    def __init__(self, pieces: list[tuple[str, float, int]],
                 context_length: int = 64, eos: str = "</s>",
                 unk: str = "<unk>", pad: str | None = None):
        self.pieces = pieces
        self.context_length = context_length
        self.vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = {p: s for p, s, _ in pieces}
        self.eos_id = self.vocab[eos]
        self.unk_id = next((i for i, (_, _, t) in enumerate(pieces)
                            if t == 2), self.vocab.get(unk, 0))
        self.pad_id = self.vocab[pad] if pad else self.eos_id
        self.max_piece_len = max((len(p) for p, _, t in pieces
                                  if t in (1, 4)), default=1)
        normal = [s for _, s, t in pieces if t == 1]
        self.unk_score = (min(normal) if normal else 0.0) - 10.0

    @classmethod
    def from_dir(cls, model_dir: str, context_length: int = 64):
        path = os.path.join(model_dir, "spiece.model")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no spiece.model under {model_dir}")
        with open(path, "rb") as f:
            return cls(parse_spiece_model(f.read()), context_length)

    @staticmethod
    def canonicalize(text: str) -> str:
        """ASCII punctuation removed, whitespace collapsed and stripped."""
        return " ".join(text.translate(_PUNCT).split())

    def _viterbi(self, s: str) -> list[int]:
        """The best-scoring segmentation of s: at each start, pieces by
        ascending length, each kept only if strictly better, then the
        one-character `<unk>`."""
        n = len(s)
        best = [-float("inf")] * (n + 1)
        back = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -float("inf"):
                continue
            for L in range(1, min(self.max_piece_len, n - i) + 1):
                cand = s[i:i + L]
                if cand in self.vocab and best[i] + self.scores[cand] > \
                        best[i + L]:
                    best[i + L] = best[i] + self.scores[cand]
                    back[i + L] = (i, self.vocab[cand])
            if best[i] + self.unk_score > best[i + 1]:
                best[i + 1] = best[i] + self.unk_score
                back[i + 1] = (i, self.unk_id)
        ids, j = [], n
        while j > 0:
            j, tid = back[j]
            ids.append(tid)
        return ids[::-1]

    def encode(self, text: str) -> list[int]:
        text = unicodedata.normalize("NFKC", self.canonicalize(text))
        return self._viterbi(SPIECE_UNDERLINE
                             + text.replace(" ", SPIECE_UNDERLINE))

    def __call__(self, texts: list[str]) -> np.ndarray:
        L = self.context_length
        out = np.full((len(texts), L), self.pad_id, np.int64)
        for r, t in enumerate(texts):
            ids = self.encode(t)[:L - 1] + [self.eos_id]
            out[r, :len(ids)] = ids
        return out
