"""VLM language transforms + offline rephrase generation.

Mirrors bridge_verifier/lang_transform_vlm.py (LangTransform, transform
types :18) and generate_simpler_rephrases_vlm.py (batch generation with
dedup + top-up rounds, BATCH_NUMBER). The reference calls the OpenAI API
with an image-conditioned prompt; this environment has zero egress, so the
VLM backend is pluggable:

  * `VLMBackend` protocol — wire up any client returning rephrase lists.
  * `TemplateBackend` — deterministic offline fallback composing rephrases
    from synonym tables (keeps the full generation pipeline runnable).
"""

from __future__ import annotations

import json
import random
import re
from typing import Dict, List, Optional, Protocol, Sequence

TRANSFORM_TYPES = ["synonym", "antonym", "negation", "verb_noun_shuffle",
                   "in_set", "out_set", "rephrase"]


class VLMBackend(Protocol):
    def rephrase(self, instruction: str, n: int,
                 image: Optional[bytes] = None) -> List[str]: ...


_SYNONYMS: Dict[str, List[str]] = {
    "put": ["place", "set", "lay", "position", "move"],
    "stack": ["pile", "place ... on top of"],
    "on": ["onto", "on top of", "upon"],
    "into": ["in", "inside"],
    "the": ["the", "that"],
    "carrot": ["carrot", "orange vegetable"],
    "plate": ["plate", "dish"],
    "towel": ["towel", "cloth", "fabric"],
    "basket": ["basket", "container", "bin"],
    "spoon": ["spoon", "utensil"],
    "eggplant": ["eggplant", "aubergine", "purple vegetable"],
    "zucchini": ["zucchini", "courgette", "green squash"],
    "block": ["block", "cube"],
    "ball": ["ball", "sphere"],
    "can": ["can", "tin"],
}

_ANTONYMS: Dict[str, str] = {
    "put": "remove", "on": "off", "into": "out of", "open": "close",
    "close": "open", "stack": "unstack", "pick": "drop",
}


class TemplateBackend:
    """Deterministic synonym-substitution rephraser (offline fallback)."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    # framing variations applied when synonym substitution alone cannot
    # produce enough distinct candidates (e.g. "open top drawer")
    _FRAMES = ("please {}", "can you {}", "{} now", "go ahead and {}",
               "i need you to {}", "{} for me", "kindly {}",
               "your task is to {}")

    def rephrase(self, instruction: str, n: int,
                 image: Optional[bytes] = None) -> List[str]:
        words = instruction.lower().split()
        out, seen = [], {instruction.lower()}
        attempts = 0
        while len(out) < n and attempts < n * 30:
            attempts += 1
            cand = " ".join(
                self.rng.choice(_SYNONYMS[w]) if w in _SYNONYMS else w
                for w in words)
            if attempts > n * 10 or (cand in seen and attempts > n * 3):
                # synonym space exhausted: add framing variation
                cand = self.rng.choice(self._FRAMES).format(cand)
            if cand not in seen:
                seen.add(cand)
                out.append(cand)
        return out


class OpenAICompatibleBackend:
    """Chat-completions HTTP backend (the reference generates rephrases via
    the OpenAI client with an image-conditioned batch prompt,
    bridge_verifier/lang_transform_vlm.py:14-224). Pure-stdlib urllib so it
    works against any OpenAI-compatible endpoint (vLLM, llama.cpp, ...).

    Disabled by default in air-gapped environments: construction raises
    unless an API key (argument or OPENAI_API_KEY) is configured — callers
    use `make_backend("auto")` to fall back to the TemplateBackend."""

    def __init__(self, base_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 model: str = "gpt-4o", timeout_s: float = 60.0,
                 max_retries: int = 2):
        import os
        self.base_url = (base_url or os.environ.get(
            "OPENAI_BASE_URL", "https://api.openai.com/v1")).rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        if not self.api_key:
            raise ValueError(
                "OpenAICompatibleBackend needs an API key (pass api_key= or "
                "set OPENAI_API_KEY); use make_backend('auto') for the "
                "offline template fallback")
        self.model = model
        self.timeout_s = timeout_s
        self.max_retries = max_retries

    # prompt mirrors the reference's numbered-list batch request
    # (system_prompts/rephrase_batch.txt semantics)
    def _messages(self, instruction: str, n: int,
                  image: Optional[bytes]) -> List[Dict]:
        text = (
            f"Rephrase the robot-manipulation instruction below {n} "
            "different ways. Keep the meaning and the referenced objects "
            "identical; vary only the phrasing. Reply with a numbered "
            f"list of exactly {n} rephrases and nothing else.\n\n"
            f"Instruction: {instruction}")
        content: List[Dict] = [{"type": "text", "text": text}]
        if image is not None:
            import base64
            b64 = base64.b64encode(image).decode()
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/png;base64,{b64}"}})
        return [{"role": "user", "content": content}]

    @staticmethod
    def _parse(text: str) -> List[str]:
        out = []
        for line in text.splitlines():
            line = re.sub(r"^\s*(?:\d+[\.\)]\s*|[-*]\s+)", "", line).strip()
            line = line.strip('"').strip()
            if line and line not in out:
                out.append(line)
        return out

    def rephrase(self, instruction: str, n: int,
                 image: Optional[bytes] = None) -> List[str]:
        import urllib.request
        payload = json.dumps({
            "model": self.model,
            "messages": self._messages(instruction, n, image),
            "temperature": 1.0,
        }).encode()
        req = urllib.request.Request(
            self.base_url + "/chat/completions", data=payload,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        last_err: Optional[Exception] = None
        for _ in range(self.max_retries + 1):
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as resp:
                    body = json.loads(resp.read().decode())
                text = body["choices"][0]["message"]["content"]
                return self._parse(text)[:n]
            except Exception as e:  # noqa: BLE001 — retry then surface
                last_err = e
        raise RuntimeError(
            f"rephrase request failed after {self.max_retries + 1} "
            f"attempts: {last_err}") from last_err


def make_backend(kind: str = "auto", seed: int = 0, **kw) -> VLMBackend:
    """"template" | "openai" | "auto" (openai when an API key is
    configured, template otherwise)."""
    if kind == "template":
        return TemplateBackend(seed)
    if kind == "openai":
        return OpenAICompatibleBackend(**kw)
    if kind == "auto":
        try:
            return OpenAICompatibleBackend(**kw)
        except ValueError:
            return TemplateBackend(seed)
    raise ValueError(f"unknown backend {kind!r} (template|openai|auto)")


class LangTransform:
    """Instruction transformations (lang_transform_vlm.py:14+)."""

    def __init__(self, backend: Optional[VLMBackend] = None, seed: int = 0):
        self.backend = backend or TemplateBackend(seed)
        self.rng = random.Random(seed)

    def transform(self, instruction: str, transform_type: str,
                  n: int = 1) -> List[str]:
        if transform_type not in TRANSFORM_TYPES:
            raise ValueError(f"unknown transform {transform_type!r}; "
                             f"one of {TRANSFORM_TYPES}")
        if transform_type in ("rephrase", "synonym"):
            return self.backend.rephrase(instruction, n)
        if transform_type == "antonym":
            words = [(_ANTONYMS.get(w, w)) for w in instruction.lower().split()]
            return [" ".join(words)][:n]
        if transform_type == "negation":
            return [f"do not {instruction.lower()}"][:n]
        if transform_type == "verb_noun_shuffle":
            words = instruction.lower().split()
            shuffled = words[:]
            self.rng.shuffle(shuffled)
            return [" ".join(shuffled)][:n]
        if transform_type == "in_set":
            return self.backend.rephrase(instruction, n)
        if transform_type == "out_set":
            return [f"{instruction.lower()} somewhere else"][:n]
        return []


def generate_rephrase_store(instructions: Sequence[str], n_per_task: int = 33,
                            backend: Optional[VLMBackend] = None,
                            seed: int = 0) -> Dict:
    """Batch rephrase generation with dedup + top-up rounds
    (generate_simpler_rephrases_vlm.py:18+, BATCH_NUMBER semantics).
    Returns the rephrase-store JSON schema."""
    lt = LangTransform(backend, seed)
    store = {"instructions": {}}
    for instr in instructions:
        reph: List[str] = []
        rounds = 0
        while len(reph) < n_per_task and rounds < 10:
            new = lt.transform(instr, "rephrase",
                               n=n_per_task - len(reph))
            reph.extend(r for r in new if r not in reph)
            rounds += 1
        store["instructions"][instr] = {
            "original": instr,
            "ert_rephrases": reph[:n_per_task],
            "rephrases_original": instr,
            "count": len(reph[:n_per_task]),
        }
    return store


def main(argv=None):
    """CLI: regenerate the rephrase store for the benchmark tasks
    (generate_simpler_rephrases_vlm.py equivalent, offline backend)."""
    import argparse
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
    ap = argparse.ArgumentParser()
    ap.add_argument("out_path")
    ap.add_argument("--n-per-task", type=int, default=33)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="template",
                    choices=["template", "openai", "auto"],
                    help="openai = OpenAI-compatible HTTP endpoint "
                         "(OPENAI_API_KEY/OPENAI_BASE_URL)")
    ap.add_argument("--model", default="gpt-4o")
    args = ap.parse_args(argv)
    instructions = sorted(set(TASK_INSTRUCTIONS.values()))
    backend = make_backend(args.backend, seed=args.seed, model=args.model) \
        if args.backend != "template" else None
    store = generate_rephrase_store(instructions, args.n_per_task,
                                    backend=backend, seed=args.seed)
    with open(args.out_path, "w") as f:
        json.dump(store, f, indent=2)
    print(f"wrote {len(instructions)} tasks -> {args.out_path}")


if __name__ == "__main__":
    main()
