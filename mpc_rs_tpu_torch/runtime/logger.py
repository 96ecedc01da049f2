"""CSV logging with the reference's column schemas.

Port of ``mpc_rs_tpu/runtime/logger.py:24-54``: the same writer and the same
row format (``repr`` of each float, one flushed row per step), so
``scripts/plot_logs.py`` reads the port's CSVs unchanged. The simple loop
writes t, u, x[0..n] (examples/mppi4.rs:56-65); the hardware log t, u,
x_est[0..6], p_diag[0..6] (mppi4-ukf-commu.rs:353-396) in a file whose name
carries the start time, as mppi4-ukf-commu.rs:354-359 names it
(``timestamped``).
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Iterable


class CsvLogger:
    def __init__(self, path: str, timestamped: bool = False):
        if timestamped:
            stem, ext = os.path.splitext(path)
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
            path = f"{stem}-{stamp}{ext or '.csv'}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._fh = open(path, "w", newline="")
        self._writer = csv.writer(self._fh)

    def write_row(self, *values: Iterable):
        flat = []
        for v in values:
            if hasattr(v, "__iter__") and not isinstance(v, str):
                flat.extend(float(c) for c in v)
            else:
                flat.append(float(v))
        self._writer.writerow([repr(v) for v in flat])
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
