"""ASCII log-scale curve plot.

Behavioral reference: ``include/src/plot.{hpp,cpp}`` — the terminal
histogram the reference prints after population-size estimation (log10 y
axis, '*' marks, min/max labels on the left, x range on the bottom).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def ascii_plot(x: Sequence[float], y: Sequence[float], width: int = 80,
               height: int = 20) -> str:
    """Render y(x) as an ASCII plot on a log10 y axis (plot.cpp:4-90):
    zero-valued and trailing points are dropped, each kept point paints a
    '*' column at its log-scaled height."""
    x = np.asarray(x, dtype=np.float64)[1:]
    y = np.asarray(y, dtype=np.float64)[1:]
    keep = (y > 0) & np.isfinite(y) & np.isfinite(x)
    if keep.sum() == 0:
        return "(no positive values to plot)\n"
    x, y = x[keep], y[keep]
    y_min, y_max = y.min(), y.max()
    ylog = np.log10(y)
    dy = (np.log10(y_max) - np.log10(y_min)) / height if y_max > y_min \
        else 1.0
    cols = max(width // max(len(x), 1), 1)
    rows = []
    lvl = ((ylog - np.log10(y_min)) / dy + 1).astype(np.int64)
    for h in range(height + 2, -1, -1):
        if h == height + 1:
            label = f"{y_max:8.2e}|"
        elif h == 1:
            label = f"{y_min:8.2e}|"
        else:
            label = "        |"
        line = "".join(("*" if lvl[k] == h else " ") * cols
                       for k in range(len(x)))
        rows.append(label + line)
    rows.append("        +" + "-" * (cols * len(x)))
    rows.append(f"         {x[0]:.2e}" + " " * max(cols * len(x) - 22, 1)
                + f"{x[-1]:.2e}")
    return "\n".join(rows) + "\n"
