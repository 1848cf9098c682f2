"""The packed sequence of a recon or chat call, worked out from the call's
inputs alone, and the visibility rule of its attention.

A (query, key) pair is visible when both rows are in one document, and the
key comes no later than the query or both rows share a full-attention span
(`fn` >= 0), and the key is no noise row of another noise span:

    (doc_q == doc_k) & (doc_q >= 0) & (doc_k >= 0)
    & (pos_k <= pos_q | (fn_q == fn_k & fn_q >= 0))
    & !(noise_k >= 0 & noise_q != noise_k)

Text takes word ids: the crc32 of each whitespace-separated word, mod 5,000,
plus 100 (one word is one token, as the system does without vocabulary files).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

BOS, EOS, SOI, EOI = 151644, 151645, 151652, 151653
RECON_PROMPT = "Reconstruct the 3D scene."
SYSTEM_PROMPT = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant"


def word_ids(text: str) -> List[int]:
    return [(zlib.crc32(w.encode()) % 5000) + 100 for w in text.split()]


def visible(q_info: Sequence[torch.Tensor], k_info: Sequence[torch.Tensor]) -> torch.Tensor:
    """(S_q, S_k) bool from the (doc, fn, noise, pos) fields of the query and the key rows."""
    dq, fq, nq, pq = (f[:, None] for f in q_info)
    dk, fk, nk, pk = (f[None, :] for f in k_info)
    return (dq == dk) & (dq >= 0) & (dk >= 0) & ((pk <= pq) | ((fq == fk) & (fq >= 0))) & ~((nk >= 0) & (nq != nk))


def visible_pairs(info: Sequence, block: int = 2048) -> int:
    """The number of visible pairs of one sequence ((doc, fn, noise, pos) arrays)."""
    f = [torch.as_tensor(np.asarray(a), dtype=torch.int64) for a in info]
    n = len(f[0])
    return sum(int(visible([a[q0:q0 + block] for a in f], f).sum()) for q0 in range(0, n, block))


@dataclass
class Layout:
    """Rows of one sequence: text ids and where they sit, the tower rows,
    the expert of each row, the 3-axis rope positions and the mask fields."""

    text_ids: List[int] = field(default_factory=list)
    text_indexes: List[int] = field(default_factory=list)
    dino_indexes: List[int] = field(default_factory=list)
    vit_indexes: List[int] = field(default_factory=list)
    is_geo: List[bool] = field(default_factory=list)
    pos3: List[np.ndarray] = field(default_factory=list)
    fn: List[int] = field(default_factory=list)
    rope: int = 0
    next_fn: int = 0
    prompt_len: int = 0

    @property
    def seq_len(self) -> int:
        return len(self.is_geo)

    def _token(self, tok: int, fn: int) -> None:
        self.text_ids.append(tok)
        self.text_indexes.append(self.seq_len)
        self.is_geo.append(False)
        self.pos3.append(np.full((3, 1), self.rope, np.int64))
        self.fn.append(fn)
        self.rope += 1

    def text(self, ids: Sequence[int]) -> "Layout":
        for t in ids:
            self._token(int(t), -1)
        return self

    def _grid(self, hp: int, wp: int, geo: bool, fn: int, into: List[int]) -> None:
        hw = hp * wp
        into.extend(range(self.seq_len, self.seq_len + hw))
        self.is_geo.extend([geo] * hw)
        self.pos3.append(np.stack([np.zeros(hw, np.int64), np.repeat(np.arange(hp), wp), np.tile(np.arange(wp), hp)])
                         + self.rope)
        self.fn.extend([fn] * hw)
        self.rope += max(hp, wp)

    def dino_views(self, n: int, hp: int, wp: int) -> "Layout":
        """Every view framed by its start and end tokens, all views one full-attention span."""
        fn = self.next_fn
        self.next_fn += 1
        for _ in range(n):
            self._token(SOI, fn)
            self._grid(hp, wp, True, fn, self.dino_indexes)
            self._token(EOI, fn)
        return self

    def vit_image(self, hp: int, wp: int) -> "Layout":
        fn = self.next_fn
        self.next_fn += 1
        self._token(SOI, fn)
        self._grid(hp, wp, False, fn, self.vit_indexes)
        self._token(EOI, fn)
        return self

    @property
    def position_ids(self) -> np.ndarray:
        return np.concatenate(self.pos3, axis=1)

    @property
    def doc_id(self) -> np.ndarray:
        return np.zeros(self.seq_len, np.int64)

    @property
    def fn_id(self) -> np.ndarray:
        return np.asarray(self.fn, np.int64)

    @property
    def noise_id(self) -> np.ndarray:
        return np.full(self.seq_len, -1, np.int64)

    @property
    def pos(self) -> np.ndarray:
        return np.arange(self.seq_len, dtype=np.int64)

    @property
    def info(self):
        return self.doc_id, self.fn_id, self.noise_id, self.pos

    def visible_pairs(self) -> int:
        """`visible_pairs(self.info)` in closed form: one document, no noise
        rows, so a query sees every earlier row and itself, and the later rows
        of its own full-attention span."""
        s = self.seq_len
        spans = np.bincount(self.fn_id[self.fn_id >= 0])
        return s * (s + 1) // 2 + int((spans * (spans - 1) // 2).sum())


def recon_layout(n_views: int, hp: int, wp: int) -> Layout:
    return Layout().text([BOS] + word_ids(RECON_PROMPT)).dino_views(n_views, hp, wp)


def chat_layout(n_views: int, hp: int, wp: int, vit_grids, question: str, served: Sequence[int] = ()) -> Layout:
    """The chat prompt (system text, the dino views, one ViT image per view,
    the question) and, after it, the decode start token and every served
    token but the last: the rows whose logits chose the served tokens."""
    lay = Layout().text(word_ids(SYSTEM_PROMPT)).dino_views(n_views, hp, wp)
    for _, gh, gw in vit_grids:
        lay.vit_image(gh // 2, gw // 2)
    lay.text(word_ids(question + CHAT_SUFFIX))
    lay.prompt_len = lay.seq_len
    if served:
        lay.text([EOS] + list(served[:-1]))
    return lay
