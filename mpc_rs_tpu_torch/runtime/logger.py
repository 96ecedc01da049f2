"""CSV logging with the reference's column schemas.

Port of ``mpc_rs_tpu/runtime/logger.py:24-54``: the same writer and the same
row format (``repr`` of each float, one flushed row per step), so
``scripts/plot_logs.py`` reads the port's CSVs unchanged. The simple loop
writes t, u, x[0..n] (examples/mppi4.rs:56-65). The timestamped file names
of the hardware logs come with the apps that write them.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable


class CsvLogger:
    def __init__(self, path: str):
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
