"""RenderConfig.validate(): silently-ignored knob combos must warn.

The reference's config system is its #define matrix (kernels.cu:13–24)
where an invalid combo fails at compile time; here every constructed
config is checked in ``__post_init__`` and constraint violations emit
RuntimeWarnings."""

import warnings

import pytest

from tpu_pathtracer.config import RenderConfig


def _warns(**kw):
    with pytest.warns(RuntimeWarning) as rec:
        cfg = RenderConfig(**kw)
    return cfg, [str(w.message) for w in rec]


def test_clean_default_config_is_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        RenderConfig()
        RenderConfig(nx=512, ny=512, ns=4, stats=True, check_nans=True)


def test_check_nans_without_stats_warns():
    _, msgs = _warns(check_nans=True)
    assert any("stats=True" in m for m in msgs)
