"""CLIP byte-pair-encoding tokenizer: the port of
eoe_tpu/models/clip/tokenizer.py (standard library and numpy only).

  * byte-level BPE over a GPT-2-style reversible byte<->unicode map,
  * 49 408-entry vocab: 256 byte symbols + 256 word-final ('</w>') byte
    symbols + 48 894 merges + <|startoftext|> / <|endoftext|>,
  * text cleanup: (optional ftfy) + double html.unescape + whitespace
    collapse + lowercase,
  * ``tokenize``: [SOT] + bpe + [EOT], zero-padded to a 77-token context,
    error on overflow.

The BPE table is the JAX package's data file, read in place by path (the
port does not import ``eoe_tpu``, whose package import pulls in jax).
ftfy and regex are optional; for the ASCII prompt templates the AD
benchmarks use ("a photo of a {cls}") the fall-backs give the same ids.
"""

import functools
import gzip
import html
import os.path as pt
from typing import List, Union

import numpy as np

try:
    import regex as _re
    _HAS_REGEX = True
except ImportError:  # pragma: no cover - regex ships with the image
    import re as _re
    _HAS_REGEX = False

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

# <repo>/eoe_tpu_torch/models/clip/ -> <repo>/eoe_tpu/models/clip/assets/
BPE_PATH = pt.join(pt.dirname(pt.dirname(pt.dirname(pt.dirname(pt.abspath(__file__))))),
                   "eoe_tpu", "models", "clip", "assets", "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77
N_MERGES = 48894  # 49152 - 256 - 2 (see reference simple_tokenizer.py:68)


@functools.lru_cache()
def _byte_unicode_map():
    """GPT-2 reversible byte->unicode printable-codepoint map. Insertion order
    matters: visible bytes first, then the shifted invisibles — the vocab's
    first 512 token ids follow this order."""
    visible = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
               + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {b: chr(b) for b in visible}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip()


class ClipTokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str = BPE_PATH):
        self._b2u = _byte_unicode_map()
        self._u2b = {u: b for b, u in self._b2u.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines[1:N_MERGES + 1]]
        symbols = list(self._b2u.values())
        vocab = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank = {m: i for i, m in enumerate(merges)}
        self._cache = {self.SOT: [self.SOT], self.EOT: [self.EOT]}
        flags = _re.IGNORECASE
        pattern = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                   + (r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+" if _HAS_REGEX
                      else r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+"))
        self._pat = _re.compile(pattern, flags)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[self.EOT]

    def _bpe(self, token: str) -> List[str]:
        """Merge the unicode-mapped token greedily by merge rank; the last
        symbol carries the word-end marker."""
        if token in self._cache:
            return self._cache[token]
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = [(self.rank.get(p, None), i) for i, p in enumerate(pairs)]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            best_rank = min(r for r, _ in ranked)
            first, second = pairs[[i for r, i in ranked if r == best_rank][0]]
            # merge ALL (non-overlapping, left-to-right) occurrences of the pair
            merged = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for token in self._pat.findall(_clean(text).lower()):
            mapped = "".join(self._b2u[b] for b in token.encode("utf-8"))
            out.extend(self.encoder[p] for p in self._bpe(mapped))
        return out

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self._u2b[c] for c in text if c in self._u2b)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_default: Union[ClipTokenizer, None] = None


def tokenize(texts: Union[str, List[str]], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """[SOT] + bpe(text) + [EOT], zero-padded (parity: clip.py:164-197).
    Returns int32 (n, context_length)."""
    global _default
    if _default is None:
        _default = ClipTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [_default.sot_token] + _default.encode(text) + [_default.eot_token]
        if len(tokens) > context_length:
            raise RuntimeError(f"Input {texts[i]} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
