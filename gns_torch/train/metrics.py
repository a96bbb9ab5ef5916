"""Structured metrics logging: CSV always, wandb when configured (the
port's copy of gns_tpu/train/metrics.py).

Replaces the reference's wandb-with-hardcoded-API-key tracking
(reference: GNS/main.py:206-207,257-272,294 — the key leak is deliberately
NOT replicated; wandb activates only when WANDB_API_KEY is set in the
environment) plus its broken time_logs.txt writer (main.py:316-318).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Appends one row per call to a CSV; optionally mirrors to wandb."""

    def __init__(
        self,
        out_dir: str = "runs",
        run_name: Optional[str] = None,
        config: Optional[dict] = None,
        use_wandb: Optional[bool] = None,
    ):
        os.makedirs(out_dir, exist_ok=True)
        self.run_name = run_name or f"run_{int(time.time())}"
        self.path = os.path.join(out_dir, f"{self.run_name}.csv")
        self._file = None
        self._writer = None
        self._wandb = None

        if config:
            with open(os.path.join(out_dir, f"{self.run_name}.config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

        if use_wandb is None:
            use_wandb = bool(os.environ.get("WANDB_API_KEY"))
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "gns_torch"),
                    name=self.run_name,
                    config=config or {},
                )
            except Exception:
                self._wandb = None  # metrics still go to CSV

    def log(self, row: dict) -> None:
        if self._writer is None:
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=sorted(row))
            if self._file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({k: row.get(k) for k in self._writer.fieldnames})
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(row)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
