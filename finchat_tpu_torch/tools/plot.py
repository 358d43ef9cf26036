"""create_financial_plot: chart generation over transaction data (own copy
of the JAX package's ``tools/plot.py``).

Renders line/bar/pie/scatter/histogram charts from a JSON list of
transactions and returns a base64 PNG data URI. Pure stdlib, numpy and
matplotlib (Agg, imported at first render); no pandas, whose DataFrame
construction off the main thread is not thread-safe.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from dataclasses import dataclass
from typing import Any

from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the chart-type enum: the grammar (agent/constrained.py) and the validator
# (agent/toolcall.py) both import it, so the three cannot drift
CHART_TYPES = ("line", "bar", "pie", "scatter", "histogram")

# matplotlib's pyplot state machine is not thread-safe; renders serialize
_RENDER_LOCK = threading.Lock()


@dataclass
class PlotConfig:
    chart_type: str = "bar"
    x_field: str = "date"
    y_field: str = "amount"
    title: str = "Financial Plot"


def _columns(rows: list[dict], fields: tuple[str, ...]) -> dict[str, list]:
    for field_name in fields:
        missing = [r for r in rows if field_name not in r]
        if missing:
            raise ValueError(f"field {field_name!r} missing from transactions")
    return {f: [r[f] for r in rows] for f in fields}


def create_financial_plot(transactions_json: str, config: PlotConfig | None = None) -> str:
    """Render a chart from transaction JSON to ``data:image/png;base64,...``.

    ``transactions_json``: a JSON list of objects with at least the
    configured x/y fields. Raises ValueError on malformed input or an
    unknown chart type."""
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    cfg = config or PlotConfig()
    if cfg.chart_type not in CHART_TYPES:
        raise ValueError(f"unknown chart_type {cfg.chart_type!r}; expected one of {CHART_TYPES}")

    rows: Any = json.loads(transactions_json)
    if not isinstance(rows, list) or not rows or not all(isinstance(r, dict) for r in rows):
        raise ValueError("transactions_json must be a non-empty JSON list of objects")
    fields = (cfg.y_field,) if cfg.chart_type == "histogram" else (cfg.x_field, cfg.y_field)
    cols = _columns(rows, fields)

    with _RENDER_LOCK:
        fig, ax = plt.subplots(figsize=(8, 5))
        try:
            if cfg.chart_type == "line":
                ax.plot(cols[cfg.x_field], cols[cfg.y_field])
            elif cfg.chart_type == "bar":
                ax.bar([str(x) for x in cols[cfg.x_field]], cols[cfg.y_field])
            elif cfg.chart_type == "scatter":
                ax.scatter(cols[cfg.x_field], cols[cfg.y_field])
            elif cfg.chart_type == "histogram":
                ax.hist(cols[cfg.y_field], bins=min(20, max(5, len(rows) // 2)))
            elif cfg.chart_type == "pie":
                totals: dict[str, float] = {}
                for x, y in zip(cols[cfg.x_field], cols[cfg.y_field]):
                    totals[str(x)] = totals.get(str(x), 0.0) + abs(float(y))
                ax.pie(list(totals.values()), labels=list(totals.keys()), autopct="%1.1f%%")
            if cfg.chart_type != "pie":
                ax.set_xlabel(cfg.x_field)
                ax.set_ylabel(cfg.y_field)
                fig.autofmt_xdate(rotation=30)
            ax.set_title(cfg.title)
            buf = io.BytesIO()
            fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        finally:
            plt.close(fig)

    encoded = base64.b64encode(buf.getvalue()).decode("ascii")
    logger.info("rendered %s chart (%d rows, %d png bytes)", cfg.chart_type, len(rows),
                len(buf.getvalue()))
    return f"data:image/png;base64,{encoded}"
