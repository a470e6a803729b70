"""Training logs: the port's copy of JSONLLogger and tokens_seen from
fourm_tpu/utils/logger.py (reference run_training_4m.py:643-669)."""

from __future__ import annotations

import json
import os
from typing import Dict


class JSONLLogger:
    """Append one JSON object of stats per line to <output_dir>/log.txt."""

    def __init__(self, output_dir: str, fname: str = "log.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, fname)

    def write(self, stats: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


def tokens_seen(step: int, global_batch_size: int, num_input_tokens: int,
                num_target_tokens: int) -> float:
    """Billions of tokens seen after `step` steps (reference run_training_4m.py:643-645)."""
    return step * global_batch_size * (num_input_tokens + num_target_tokens) / 1e9
