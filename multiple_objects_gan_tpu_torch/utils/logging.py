"""Scalar logs of a training run (the port's copy of the JAX package's
``utils/logging.py:MetricWriter``).

The reference writes tensorboard scalars every 500 steps
(code/multi-mnist/trainer.py:163-174). Every record goes to
``<logdir>/metrics.jsonl``, one JSON object a line; tensorboard gets the
same scalars when ``torch.utils.tensorboard`` imports (it needs the
tensorboard package, which the card's machine need not have).
"""

from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: dict) -> None:
        self._f.write(json.dumps({"step": step, "time": time.time(),
                                  **values}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
