"""Tokenizer abstraction for the policy (PaliGemma) and verifier (SigLIP2).

Production uses HuggingFace tokenizers ("google/paligemma-3b-pt-224" for
the policy — modeling_pi0.py:250, and the SigLIP2 gemma tokenizer for the
verifier — finetune...py:617). In air-gapped environments where tokenizer
files are unavailable, `HashTokenizer` provides a deterministic stand-in
with the same interface so the full pipeline remains runnable end-to-end
(bench, tests, fake-env episodes).
"""

from __future__ import annotations

import hashlib
import logging
from typing import List, Protocol, Sequence, Tuple

import numpy as np

log = logging.getLogger("cover_vla_tpu_torch.tokenizer")


class Tokenizer(Protocol):
    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens int32[B, max_length], mask bool[B, max_length])."""
        ...


class HashTokenizer:
    """Deterministic word-hash tokenizer (fallback; not a real vocabulary).

    Right-pads like the PaliGemma path (padding='max_length',
    padding_side='right') and appends a newline-terminator token the way
    pi0 appends '\\n' to every prompt (modeling_pi0.py:396).
    """

    def __init__(self, vocab_size: int, pad_id: int = 0, bos_id: int = 2,
                 add_bos: bool = True):
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.add_bos = add_bos

    def _word_id(self, word: str) -> int:
        h = hashlib.md5(word.encode()).digest()
        return 3 + int.from_bytes(h[:4], "little") % (self.vocab_size - 3)

    def encode(self, text: str, max_length: int) -> List[int]:
        ids = [self.bos_id] if self.add_bos else []
        for w in text.strip().lower().split():
            ids.append(self._word_id(w))
        ids.append(self._word_id("\n"))
        return ids[:max_length]

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        tokens = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), bool)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length)
            tokens[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        return tokens, mask


class HFTokenizer:
    """HuggingFace-backed tokenizer (requires local tokenizer files).

    `add_bos=False` strips a tokenizer-prepended BOS so a transformers
    save_pretrained directory produces the same token stream as the bare
    tokenizer.json FileTokenizer path (open_clip SigLIP2 text-tower
    semantics: no BOS)."""

    def __init__(self, name_or_path: str, append_newline: bool = True,
                 add_bos: bool = True):
        from transformers import AutoTokenizer
        # local_files_only: fail fast in air-gapped environments instead of
        # burning ~1 min in network retries before the Hash fallback kicks in
        self.tok = AutoTokenizer.from_pretrained(name_or_path,
                                                 local_files_only=True)
        self.append_newline = append_newline
        self.add_bos = add_bos

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if self.append_newline:
            texts = [t if t.endswith("\n") else f"{t}\n" for t in texts]
        # encode un-truncated, then strip BOS if requested, then pad/cut —
        # so BOS-stripping never eats a content token at the boundary
        out = self.tok(list(texts), padding=False, truncation=False)
        bos = getattr(self.tok, "bos_token_id", None)
        pad = self.tok.pad_token_id or 0
        tokens = np.full((len(texts), max_length), pad, np.int32)
        mask = np.zeros((len(texts), max_length), bool)
        for i, ids in enumerate(out["input_ids"]):
            if not self.add_bos and bos is not None and ids and ids[0] == bos:
                ids = ids[1:]
            ids = ids[:max_length]
            tokens[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        return tokens, mask


class FileTokenizer:
    """Real-vocabulary tokenizer from a bare `tokenizer.json` file
    (HF `tokenizers` serialization) — the offline path for PaliGemma /
    SigLIP2 vocabularies when the artifact file is on disk but no full
    transformers config dir exists.

    Reproduces the pi0 prompt semantics (modeling_pi0.py:389-409): optional
    BOS, trailing '\\n', right padding to max_length with a pad mask.
    """

    def __init__(self, path: str, append_newline: bool = True,
                 add_bos: bool = True, bos_id: int = 2, pad_id: int = 0):
        from tokenizers import Tokenizer as HFTok
        self.tok = HFTok.from_file(path)
        self.append_newline = append_newline
        self.add_bos = add_bos
        self.bos_id = bos_id
        self.pad_id = pad_id
        self.vocab_size = self.tok.get_vocab_size()

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if self.append_newline:
            texts = [t if t.endswith("\n") else f"{t}\n" for t in texts]
        encs = self.tok.encode_batch(list(texts))
        tokens = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), bool)
        for i, e in enumerate(encs):
            ids = ([self.bos_id] if self.add_bos else []) + list(e.ids)
            ids = ids[:max_length]
            tokens[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        return tokens, mask


def _file_or_hf(path: str, **kw) -> Tokenizer:
    import os
    if path.endswith(".json") and os.path.exists(path):
        return FileTokenizer(path, **kw)
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "tokenizer.json")) and not os.path.exists(
            os.path.join(path, "tokenizer_config.json")):
        return FileTokenizer(os.path.join(path, "tokenizer.json"), **kw)
    return HFTokenizer(path, append_newline=kw.get("append_newline", True),
                       add_bos=kw.get("add_bos", True))


def make_policy_tokenizer(vocab_size: int,
                          hf_path: str = "google/paligemma-3b-pt-224",
                          strict: bool = False) -> Tokenizer:
    """Real PaliGemma vocabulary when available; HashTokenizer otherwise.

    The fallback is a fake vocabulary — fine for random-weight bench/tests,
    GARBAGE for real checkpoints. It therefore always warns, and raises when
    `strict=True` (eval/serve roles with a real checkpoint set strict unless
    --allow_hash_tokenizer)."""
    try:
        return _file_or_hf(hf_path)
    except Exception as e:
        if strict:
            raise RuntimeError(
                f"policy tokenizer artifacts unavailable at {hf_path!r}; "
                "real-checkpoint inference would emit garbage actions under "
                "the hash fallback (pass --allow_hash_tokenizer to override)"
            ) from e
        log.warning(
            "policy tokenizer %r unavailable (%s): falling back to "
            "HashTokenizer — a FAKE vocabulary only valid for random-weight "
            "runs", hf_path, type(e).__name__)
        return HashTokenizer(vocab_size)


def make_verifier_tokenizer(vocab_size: int, hf_path: str | None = None,
                            strict: bool = False) -> Tokenizer:
    if hf_path:
        try:
            return _file_or_hf(hf_path, append_newline=False, add_bos=False)
        except Exception as e:
            if strict:
                raise RuntimeError(
                    f"verifier tokenizer artifacts unavailable at "
                    f"{hf_path!r} (pass --allow_hash_tokenizer to override)"
                ) from e
            log.warning(
                "verifier tokenizer %r unavailable (%s): falling back to "
                "HashTokenizer", hf_path, type(e).__name__)
    elif strict:
        raise RuntimeError(
            "no verifier tokenizer artifact configured; real-checkpoint "
            "scoring would be garbage under the hash fallback "
            "(pass --allow_hash_tokenizer to override)")
    return HashTokenizer(vocab_size, add_bos=False)
