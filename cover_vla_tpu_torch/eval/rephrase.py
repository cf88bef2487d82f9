"""Rephrase store: task instruction -> VLM-generated rephrases.

Schema mirrors simpler_rephrased_final_eval_vlm.json (eval_utils.py:293-308):
{"instructions": {original: {"original": str, "ert_rephrases": [str, ...],
 "rephrases_original": str, "random_rephrases": str, "count": int}}}.
The vendored JSON is generated data (GPT-4V rephrases of the 7 SIMPLER
task instructions), not code.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

_HERE = os.path.dirname(__file__)
DEFAULT_REPHRASE_PATH = os.path.join(_HERE, "simpler_rephrases.json")


def load_rephrases(path: str = DEFAULT_REPHRASE_PATH) -> Dict[str, List[str]]:
    """Returns {original instruction: [rephrases...]}."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for orig, entry in raw.get("instructions", {}).items():
        out[orig] = list(entry.get("ert_rephrases", []))
    return out


def save_rephrases(store: Dict[str, List[str]], path: str) -> None:
    payload = {"instructions": {
        orig: {"original": orig, "ert_rephrases": list(reph),
               "rephrases_original": orig, "count": len(reph)}
        for orig, reph in store.items()}}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
