"""The port's ``create_financial_plot`` against the JAX package's, over the
inputs of tests/test_plot.py: both data URIs decode to equal pixel arrays,
and a bad input raises the same error type with the same message."""

import base64
import io
import json

import numpy as np
import pytest

from finchat_tpu.tools.plot import CHART_TYPES as JAX_CHART_TYPES
from finchat_tpu.tools.plot import PlotConfig as JaxPlotConfig
from finchat_tpu.tools.plot import create_financial_plot as jax_plot
from finchat_tpu_torch.tools.plot import CHART_TYPES, PlotConfig, create_financial_plot

ROWS = json.dumps([
    {"date": "2026-01", "amount": 120.5, "category": "groceries"},
    {"date": "2026-02", "amount": 80.0, "category": "dining"},
    {"date": "2026-03", "amount": 200.0, "category": "groceries"},
])


def _pixels(uri: str) -> np.ndarray:
    import matplotlib.image as mpimg

    prefix = "data:image/png;base64,"
    assert uri.startswith(prefix)
    return mpimg.imread(io.BytesIO(base64.b64decode(uri[len(prefix):])), format="png")


@pytest.mark.parametrize("cfg", [
    dict(chart_type="line"), dict(chart_type="bar"), dict(chart_type="scatter"),
    dict(chart_type="histogram"), dict(chart_type="pie", x_field="category"),
    dict(chart_type="bar", title="Spending This Month"),
], ids=lambda c: "-".join(str(v) for v in c.values()))
def test_plot_pixels_match_jax(cfg):
    got = _pixels(create_financial_plot(ROWS, PlotConfig(**cfg)))
    want = _pixels(jax_plot(ROWS, JaxPlotConfig(**cfg)))
    assert got.shape == want.shape and got.shape[-1] in (3, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [
    (ROWS, dict(chart_type="sunburst")),
    ("[]", None),
    (ROWS, dict(y_field="nope")),
    ('{"date": 1}', None),
    ("not json", None),
], ids=["unknown-chart", "empty-rows", "missing-field", "not-a-list", "not-json"])
def test_plot_errors_match_jax(args):
    text, cfg = args
    with pytest.raises(Exception) as got:
        create_financial_plot(text, PlotConfig(**cfg) if cfg else None)
    with pytest.raises(Exception) as want:
        jax_plot(text, JaxPlotConfig(**cfg) if cfg else None)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_chart_types_and_defaults_match_jax():
    assert CHART_TYPES == JAX_CHART_TYPES
    assert vars(PlotConfig()) == vars(JaxPlotConfig())
