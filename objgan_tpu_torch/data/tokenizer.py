"""Caption tokenization + vocabulary, without JAX.

A copy of ``objgan_tpu/data/tokenizer.py`` for the port: importing
``objgan_tpu.data`` imports JAX (its ``__init__`` pulls in ``synthetic.py``),
and the port never imports JAX. Same contract: lowercase ``\\w+`` regex
tokens, index 0 = '<end>' padding, index 1 = '<unk>' in vocabs built here.
``tests/test_torch_data.py`` holds the two copies to identical ids.
"""

from __future__ import annotations

import pickle
import re
import warnings
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"\w+")

PAD = 0
PAD_TOKEN = "<end>"
# Out-of-vocabulary token (id 1 in vocabs built here). The lineage sidesteps
# OOV by building its vocab over train+test captions; user captions at
# sample_pipeline time have no such guarantee, so novel words map to <unk>
# (which gets training signal via TEXT.WORD_DROPOUT) instead of being
# silently dropped (VERDICT r2 missing #5). Reference pickles without an
# <unk> entry keep the historical drop-with-warning behavior.
UNK_TOKEN = "<unk>"


def tokenize(caption: str) -> List[str]:
    return _TOKEN_RE.findall(caption.lower())


class Vocab:
    def __init__(self, wordtoix: Dict[str, int]):
        # id 0 is PAD everywhere downstream (validity masks, decode): it
        # must belong to PAD_TOKEN and to nothing else. The check is
        # explicit — a .get(default=0) guard would pass vacuously when
        # '<end>' is absent while a REAL word owns index 0, making that
        # word silently vanish from attention and decoding.
        if wordtoix.get(PAD_TOKEN) != PAD:
            raise ValueError(
                f"vocab must map {PAD_TOKEN!r} to index {PAD} (got "
                f"{wordtoix.get(PAD_TOKEN)!r}); index 0 is the framework-"
                "wide padding id")
        owners = [w for w, i in wordtoix.items() if i == PAD]
        if owners != [PAD_TOKEN]:
            raise ValueError(
                f"vocab index {PAD} is owned by {owners!r}; only "
                f"{PAD_TOKEN!r} may map to the padding id")
        self.wordtoix = dict(wordtoix)
        self.ixtoword = {i: w for w, i in wordtoix.items()}
        # None for reference pickles that predate the token (OOV words are
        # then dropped with a warning rather than mapped)
        self.unk = self.wordtoix.get(UNK_TOKEN)

    def __len__(self) -> int:
        return len(self.wordtoix)

    @classmethod
    def build(cls, captions: Iterable[str], min_count: int = 1) -> "Vocab":
        counts = Counter()
        for cap in captions:
            counts.update(tokenize(cap))
        wordtoix = {PAD_TOKEN: PAD, UNK_TOKEN: 1}
        for w, c in sorted(counts.items()):
            if c >= min_count and w not in wordtoix:
                wordtoix[w] = len(wordtoix)
        return cls(wordtoix)

    @classmethod
    def from_reference_pickle(cls, path: str) -> "Vocab":
        """Load the lineage's ``captions.pickle`` ([train, test, ixtoword,
        wordtoix]) so reference-tokenized datasets port unchanged. The
        artifact is written by a Python-2 pipeline: py2 ``str`` bytes need
        ``encoding='latin1'`` to unpickle under py3 (COCO captions contain
        non-ASCII), so that path is tried on UnicodeDecodeError."""
        with open(path, "rb") as f:
            try:
                data = pickle.load(f)
            except UnicodeDecodeError:
                f.seek(0)
                data = pickle.load(f, encoding="latin1")
        wordtoix = data[3] if isinstance(data, (list, tuple)) else data
        return cls(dict(wordtoix))

    def encode(self, caption: str, max_len: int) -> Tuple[np.ndarray, int]:
        toks = tokenize(caption)
        ids: List[int] = []
        oov: List[str] = []
        for t in toks:
            ix = self.wordtoix.get(t)
            if ix is not None:
                ids.append(ix)
            else:
                oov.append(t)
                if self.unk is not None:
                    ids.append(self.unk)
        if oov and (self.unk is None or len(oov) * 2 >= max(len(toks), 1)):
            what = ("mapped to <unk>" if self.unk is not None
                    else "DROPPED (vocab has no <unk>)")
            warnings.warn(
                f"caption {caption!r}: {len(oov)}/{len(toks)} words are "
                f"out-of-vocabulary ({oov[:5]}...) and were {what}; the "
                f"model cannot ground these words", stacklevel=2)
        ids = ids[:max_len]
        out = np.zeros((max_len,), np.int32)
        out[: len(ids)] = ids
        return out, max(len(ids), 1)

    def encode_batch(self, captions: Sequence[str], max_len: int):
        caps = np.zeros((len(captions), max_len), np.int32)
        lens = np.zeros((len(captions),), np.int32)
        for i, c in enumerate(captions):
            caps[i], lens[i] = self.encode(c, max_len)
        return caps, lens

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside the vocab (padded embedding tables, mismatched
        # checkpoint/vocab pairs) render as '#<id>' placeholders — decode
        # sits on logging/visualization paths and must not crash them
        return " ".join(
            self.ixtoword.get(int(i), f"#{int(i)}")
            for i in ids if int(i) != PAD
        )
