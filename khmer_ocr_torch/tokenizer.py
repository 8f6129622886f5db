"""Character tokenizer over the bundled 124-entry vocabulary.

<pad>=0, <unk>=1, <sos>=2, <eos>=3, then ASCII and Khmer code points.
``encode`` frames a label with <sos>/<eos>, unknown characters -> <unk>;
``decode`` skips <sos>/<pad> and stops at <eos>.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_DEFAULT_VOCAB = Path(__file__).resolve().parent / "assets" / "char2idx.json"


def default_vocab_path() -> Path:
    """The bundled vocabulary."""
    return _DEFAULT_VOCAB


class Tokenizer:
    def __init__(self, char2idx_path: str | Path | None = None):
        path = Path(char2idx_path) if char2idx_path else default_vocab_path()
        if not path.exists():
            raise FileNotFoundError(f"Vocab file not found: {path}")
        with open(path, "r", encoding="utf-8") as f:
            self.char2idx: dict[str, int] = json.load(f)
        self.idx2char = {v: k for k, v in self.char2idx.items()}
        self.sos_idx = self.char2idx.get("<sos>", 1)
        self.eos_idx = self.char2idx.get("<eos>", 2)
        self.pad_idx = self.char2idx.get("<pad>", 0)
        self.unk_idx = self.char2idx.get("<unk>", 1)

    def __len__(self) -> int:
        return len(self.char2idx)

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        """<sos>, the characters' ids, <eos> (the ids alone without ``add_special``)."""
        ids = [self.char2idx.get(ch, self.unk_idx) for ch in text]
        return [self.sos_idx] + ids + [self.eos_idx] if add_special else ids

    def encode_padded(self, texts: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """(B, max_len) int32 ids padded with <pad>, and the lengths; a label
        longer than max_len is cut, keeping its <eos>."""
        out = np.full((len(texts), max_len), self.pad_idx, dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if len(ids) > max_len:
                ids = ids[:max_len - 1] + [self.eos_idx]
            out[i, :len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths

    def decode(self, token_ids) -> str:
        """Ids -> string: skip <sos>/<pad>, stop at <eos>, unknown ids -> ''."""
        result = []
        for idx in np.asarray(token_ids).tolist():
            idx = int(idx)
            if idx == self.sos_idx or idx == self.pad_idx:
                continue
            if idx == self.eos_idx:
                break
            result.append(self.idx2char.get(idx, ""))
        return "".join(result)

    def decode_batch(self, token_ids) -> list[str]:
        return [self.decode(row) for row in np.asarray(token_ids)]
