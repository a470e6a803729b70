"""Training logs: the port's copy of fourm_tpu/utils/logger.py (reference
fourm/utils/logger.py:34-228, run_training_4m.py:643-669): smoothed values,
MetricLogger with throughput / ETA lines, the JSONL log, tokens seen, and
the wandb writer, which here only says that wandb is absent (the port
imports no wandb)."""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """A series with windowed and global statistics (reference logger.py:34-96)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    """Windowed metrics and `log_every` with iteration / data times and ETA
    (reference logger.py:99-182)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total_len: Optional[int] = None):
        i = 0
        total = total_len if total_len is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total is not None:
                    eta = str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}", flush=True)


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


class WandbLogger:
    """The wandb writer's interface (reference logger.py:185-228). Without a
    project it does nothing; with one it prints the line the JAX package
    prints where wandb is absent, and carries on."""

    def __init__(self, project: Optional[str] = None, entity: Optional[str] = None,
                 name: Optional[str] = None, config: Optional[Dict] = None):
        self.run = None
        if project is not None:
            print("[logger] wandb disabled: No module named 'wandb'")

    def log(self, stats: Dict, step: Optional[int] = None):
        pass

    def finish(self):
        pass
