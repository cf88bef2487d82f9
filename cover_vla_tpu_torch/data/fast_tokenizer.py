"""FAST-style action tokenization: DCT -> quantize -> (optional) BPE.

The port's own copy of the reference package's numpy/scipy tokenizer (it
imports nothing of that package). The "physical-intelligence/fast"
action-token pipeline:

  encode:  normalize to [-1,1] -> DCT-II (norm='ortho', time axis) ->
           * scale -> round/clip to [min_token, max_token] -> flatten
           (row-major [T, D]) -> shift to symbols -> BPE merge
  decode:  BPE expand -> unshift -> truncate/zero-pad to T*D ("relaxed
           decoding") -> reshape [T, D] -> IDCT(x / scale).

The published FAST BPE vocabulary is a hub artifact; `SimpleBPE` provides a
trainable drop-in (train on your action corpus) and `bpe=None` degrades to
one token per DCT coefficient, both invertible through the same API.
`HubFastProcessor` reads a saved artifact from disk and imports the
`tokenizers` package only when it is used.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.fft import dct, idct


class SimpleBPE:
    """Minimal byte-pair encoder over integer symbol sequences."""

    def __init__(self, base_vocab: int = 256):
        self.base_vocab = base_vocab
        self.merges: Dict[Tuple[int, int], int] = {}
        self.decomp: Dict[int, Tuple[int, int]] = {}

    @property
    def vocab_size(self) -> int:
        return self.base_vocab + len(self.merges)

    def train(self, corpus: Sequence[Sequence[int]], num_merges: int):
        seqs = [list(s) for s in corpus]
        for _ in range(num_merges):
            pairs = Counter()
            for s in seqs:
                pairs.update(zip(s[:-1], s[1:]))
            if not pairs:
                break
            (a, b), count = pairs.most_common(1)[0]
            if count < 2:
                break
            new_id = self.vocab_size
            self.merges[(a, b)] = new_id
            self.decomp[new_id] = (a, b)
            seqs = [self._merge(s, a, b, new_id) for s in seqs]
        return self

    @staticmethod
    def _merge(seq: List[int], a: int, b: int, new_id: int) -> List[int]:
        out, i = [], 0
        while i < len(seq):
            if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                out.append(new_id)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return out

    def encode(self, symbols: Sequence[int]) -> List[int]:
        seq = list(symbols)
        # apply merges in creation order (priority order)
        for (a, b), new_id in self.merges.items():
            seq = self._merge(seq, a, b, new_id)
        return seq

    def decode(self, tokens: Sequence[int]) -> List[int]:
        out: List[int] = []

        def expand(t: int):
            if t in self.decomp:
                a, b = self.decomp[t]
                expand(a)
                expand(b)
            else:
                out.append(t)

        for t in tokens:
            expand(t)
        return out


class FastActionTokenizer:
    """DCT+quantization action tokenizer with the FAST decode semantics."""

    def __init__(self, scale: float = 10.0, min_token: int = -128,
                 max_token: int = 127, bpe: Optional[SimpleBPE] = None,
                 time_horizon: Optional[int] = None,
                 action_dim: Optional[int] = None):
        self.scale = scale
        self.min_token = min_token
        self.max_token = max_token
        self.bpe = bpe
        self.time_horizon = time_horizon
        self.action_dim = action_dim

    @property
    def vocab_size(self) -> int:
        base = self.max_token - self.min_token + 1
        return self.bpe.vocab_size if self.bpe is not None else base

    def encode(self, actions: np.ndarray) -> List[List[int]]:
        """actions: [B, T, D] normalised to [-1, 1] -> per-sample tokens."""
        actions = np.asarray(actions, np.float64)
        b, t, d = actions.shape
        self.time_horizon, self.action_dim = t, d
        coeff = dct(actions, axis=1, norm="ortho") * self.scale
        ints = np.clip(np.round(coeff), self.min_token, self.max_token
                       ).astype(np.int64)
        out = []
        for i in range(b):
            symbols = (ints[i].reshape(-1) - self.min_token).tolist()
            out.append(self.bpe.encode(symbols) if self.bpe else symbols)
        return out

    def decode(self, tokens: Sequence[Sequence[int]],
               time_horizon: Optional[int] = None,
               action_dim: Optional[int] = None,
               relaxed: bool = True) -> np.ndarray:
        """Token lists -> [B, T, D] actions (relaxed truncate/pad like the
        reference decode_actions_with_fast)."""
        t = time_horizon or self.time_horizon
        d = action_dim or self.action_dim
        assert t is not None and d is not None, "horizon/dim unknown"
        out = []
        for tok in tokens:
            symbols = self.bpe.decode(tok) if self.bpe else list(tok)
            coeff = np.asarray(symbols, np.float64) + self.min_token
            expected = t * d
            if relaxed:
                if coeff.shape[0] > expected:
                    coeff = coeff[:expected]
                elif coeff.shape[0] < expected:
                    coeff = np.pad(coeff, (0, expected - coeff.shape[0]))
            try:
                grid = coeff.reshape(t, d)
            except ValueError:
                grid = np.zeros((t, d))
            out.append(idct(grid / self.scale, axis=0, norm="ortho"))
        return np.stack(out)


class HubFastProcessor:
    """FAST processor backed by a saved hub artifact directory.

    The published "physical-intelligence/fast" artifact
    (modeling_pi0fast.py:403-407) is an HF processor repo containing a
    trained BPE vocabulary (`tokenizer.json`, HF `tokenizers` format) plus
    a processor config with the DCT quantisation parameters. This loader
    reads that saved format from DISK (no hub access): quantised DCT
    coefficients are mapped to a unicode alphabet
    (chr(alphabet_offset + v - min_token)) and encoded with the artifact's
    BPE; decode inverts exactly. `save_artifact` writes the same layout for
    fixtures / locally trained vocabularies.

    Config keys honoured (processor_config.json, falling back to
    tokenizer_config.json): scale, min_token, max_token, alphabet_offset,
    time_horizon, action_dim.
    """

    CONFIG_FILES = ("processor_config.json", "tokenizer_config.json")

    def __init__(self, bpe, scale: float = 10.0, min_token: int = -128,
                 max_token: int = 127, alphabet_offset: int = 0x100,
                 time_horizon: Optional[int] = None,
                 action_dim: Optional[int] = None):
        self.bpe = bpe                      # tokenizers.Tokenizer
        self.scale = scale
        self.min_token = min_token
        self.max_token = max_token
        self.alphabet_offset = alphabet_offset
        self.time_horizon = time_horizon
        self.action_dim = action_dim

    # -- artifact IO --------------------------------------------------------

    @classmethod
    def from_artifact(cls, path: str) -> "HubFastProcessor":
        import json
        import os
        from tokenizers import Tokenizer as HFTok
        cfg = {}
        for name in cls.CONFIG_FILES:
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p) as f:
                    cfg.update({k: v for k, v in json.load(f).items()
                                if k in ("scale", "min_token", "max_token",
                                         "alphabet_offset", "time_horizon",
                                         "action_dim")})
        bpe = HFTok.from_file(os.path.join(path, "tokenizer.json"))
        return cls(bpe, **cfg)

    def save_artifact(self, path: str) -> None:
        import json
        import os
        os.makedirs(path, exist_ok=True)
        self.bpe.save(os.path.join(path, "tokenizer.json"))
        with open(os.path.join(path, "processor_config.json"), "w") as f:
            json.dump({"scale": self.scale, "min_token": self.min_token,
                       "max_token": self.max_token,
                       "alphabet_offset": self.alphabet_offset,
                       "time_horizon": self.time_horizon,
                       "action_dim": self.action_dim}, f)

    @classmethod
    def train(cls, action_corpus: np.ndarray, vocab_size: int = 1024,
              scale: float = 10.0, min_token: int = -128,
              max_token: int = 127) -> "HubFastProcessor":
        """Train a BPE vocabulary over a corpus of normalised action chunks
        [N, T, D] (the artifact-production path)."""
        from tokenizers import Tokenizer as HFTok
        from tokenizers.models import BPE
        from tokenizers.trainers import BpeTrainer
        proc = cls(None, scale=scale, min_token=min_token,
                   max_token=max_token,
                   time_horizon=action_corpus.shape[1],
                   action_dim=action_corpus.shape[2])
        texts = [proc._ints_to_text(s) for s in proc._quantize(action_corpus)]
        alphabet = [chr(proc.alphabet_offset + i)
                    for i in range(max_token - min_token + 1)]
        tok = HFTok(BPE(unk_token=None))
        trainer = BpeTrainer(vocab_size=vocab_size, initial_alphabet=alphabet,
                             special_tokens=[], show_progress=False)
        tok.train_from_iterator(texts, trainer)
        proc.bpe = tok
        return proc

    # -- the DCT <-> token pipeline -----------------------------------------

    def _quantize(self, actions: np.ndarray) -> np.ndarray:
        coeff = dct(np.asarray(actions, np.float64), axis=1,
                    norm="ortho") * self.scale
        return np.clip(np.round(coeff), self.min_token,
                       self.max_token).astype(np.int64)

    def _ints_to_text(self, grid: np.ndarray) -> str:
        return "".join(chr(self.alphabet_offset + int(v) - self.min_token)
                       for v in grid.reshape(-1))

    def _text_to_ints(self, text: str) -> np.ndarray:
        return np.asarray(
            [ord(c) - self.alphabet_offset + self.min_token for c in text],
            np.float64)

    def __call__(self, actions: np.ndarray) -> List[List[int]]:
        """Normalised [B, T, D] actions -> BPE token id lists (the
        fast_tokenizer_wrapper input contract, modeling_pi0fast.py:550)."""
        actions = np.asarray(actions)
        self.time_horizon, self.action_dim = actions.shape[1:3]
        return [self.bpe.encode(self._ints_to_text(g)).ids
                for g in self._quantize(actions)]

    encode = __call__

    def decode(self, tokens: Sequence[Sequence[int]],
               time_horizon: Optional[int] = None,
               action_dim: Optional[int] = None) -> np.ndarray:
        """Relaxed decode (truncate/pad to T*D) -> IDCT, like
        decode_actions_with_fast (modeling_pi0fast.py:753-809)."""
        t = time_horizon or self.time_horizon
        d = action_dim or self.action_dim
        out = []
        for tok in tokens:
            # join token strings directly (Tokenizer.decode would insert
            # spaces without a configured decoder)
            text = "".join(self.bpe.id_to_token(int(i)) for i in tok)
            coeff = self._text_to_ints(text)
            expected = t * d
            if coeff.shape[0] > expected:
                coeff = coeff[:expected]
            elif coeff.shape[0] < expected:
                coeff = np.pad(coeff, (0, expected - coeff.shape[0]))
            out.append(idct(coeff.reshape(t, d) / self.scale,
                            axis=0, norm="ortho"))
        return np.stack(out)

    @property
    def vocab_size(self) -> int:
        return self.bpe.get_vocab_size()


def normalize_actions_minmax(actions: np.ndarray) -> np.ndarray:
    """Per-sample min-max to [-1,1] (modeling_pi0fast.py:540-543)."""
    mins = actions.min(axis=(1, 2), keepdims=True)
    maxs = actions.max(axis=(1, 2), keepdims=True)
    return 2 * (actions - mins) / (maxs - mins + 1e-8) - 1
