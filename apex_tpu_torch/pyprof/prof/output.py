"""Columnar writer, the port's copy of ``apex_tpu/pyprof/prof/output.py``
(reference: apex/pyprof/prof/output.py)."""
from __future__ import annotations

import sys


class Table:
    def __init__(self, headers, file=None):
        self.headers = [str(h) for h in headers]
        self.rows = []
        self.file = file or sys.stdout

    def row(self, cells):
        self.rows.append([str(c) for c in cells])

    def flush(self):
        widths = [len(h) for h in self.headers]
        for r in self.rows:
            for i, c in enumerate(r):
                widths[i] = max(widths[i], len(c))
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        print(fmt.format(*self.headers), file=self.file)
        print("  ".join("-" * w for w in widths), file=self.file)
        for r in self.rows:
            print(fmt.format(*r), file=self.file)
