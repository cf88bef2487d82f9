"""Metric sinks: JSONL (always) + wandb (when importable & configured).

The reference logs everything to wandb; in air-gapped runs the JSONL sink
keeps a machine-readable record with the same step/metric schema.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class JsonlSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class WandbSink:
    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict] = None,
                 resume_id: Optional[str] = None):
        import wandb
        self.run = wandb.init(project=project, name=name, config=config,
                              id=resume_id,
                              resume="allow" if resume_id else None)

    def log(self, metrics: Dict, step: Optional[int] = None):
        self.run.log(metrics, step=step)

    def close(self):
        self.run.finish()


class MultiSink:
    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def log(self, metrics: Dict, step: Optional[int] = None):
        for s in self.sinks:
            s.log(metrics, step=step)

    def close(self):
        for s in self.sinks:
            s.close()


def make_sinks(jsonl_path: Optional[str] = None,
               wandb_project: Optional[str] = None, **wandb_kw) -> MultiSink:
    sinks = []
    if jsonl_path:
        sinks.append(JsonlSink(jsonl_path))
    if wandb_project:
        try:
            sinks.append(WandbSink(wandb_project, **wandb_kw))
        except Exception:  # no wandb or no network: JSONL only
            pass
    return MultiSink(*sinks)
