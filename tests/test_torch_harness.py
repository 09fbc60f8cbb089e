"""Port parity: npe_pfn_tpu_torch.eval.harness against npe_pfn_tpu.eval.harness.

A tiny model (d_model 32, 2 layers, f32, the JAX model's weights) on small
grids. Exact checks: the cells' keys are the JAX harness's ``_cell_key`` of
the grid, with its metric names; resuming keeps finished cells (wall_s and all)
and runs only the missing ones; a second run from the same seeds reads the
same numbers; ``summarize`` of a fixed results dict equals the JAX package's;
refinement on a joint task raises. Metric values differ from JAX's (other random streams) and
are only required finite, with c2st in [0, 1].
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.eval import harness as jh
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.tasks import get_task as jax_get_task
from npe_pfn_tpu_torch.eval import harness as th
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
from npe_pfn_tpu_torch.tasks import get_task
from torch_parity import port_model

torch.set_num_threads(2)
SMALL = dict(num_test=16, num_posterior_samples=32, n_obs_eval=2)
METRICS = {"wall_s", "c2st", "wasserstein", "mmd"}


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=32, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    return jm, port_model(jm)


def _run(tm, name, **kw):
    kw = {**SMALL, **kw}
    return th.evaluate_task(get_task(name, device="cpu"), estimator_kwargs=dict(
        model=tm, qry_chunk=32), device="cpu", **kw)


def _check_cells(res, keys):
    assert sorted(res["cells"]) == sorted(keys)
    for cell in res["cells"].values():
        assert set(cell) == METRICS
        assert all(math.isfinite(v) for v in cell.values())
        assert 0.0 <= cell["c2st"] <= 1.0


def test_grid_has_the_jax_harness_cells(models):
    """Two num_cal cells of a task with a reference posterior (cached across
    the grid), and the keys the JAX harness writes."""
    got = _run(models[1], "gaussian_linear", num_cal_grid=(20, 40), seeds=(0,))
    assert got["task"] == jax_get_task("gaussian_linear").name
    _check_cells(got, [jh._cell_key(20, 0), jh._cell_key(40, 0)])


@pytest.mark.parametrize("name", ["sir", "gaussian_bump_image"])
def test_joint_tasks(models, name):
    """The joint diagnostic: plain C2ST (sir) and the conv discriminator over
    the image with the random projection the harness adds for 1024-D x."""
    _check_cells(_run(models[1], name, num_cal_grid=(40,), seeds=(0,)), ["num_cal=40/seed=0"])


def test_resume_keeps_cells_and_repeats_exactly(models, tmp_path):
    tm = models[1]
    path = str(tmp_path / "res" / "wind_tunnel.json")
    first = _run(tm, "wind_tunnel", num_cal_grid=(20,), seeds=(0,), results_path=path)
    assert os.path.exists(path) and os.path.exists(path[:-5] + ".pkl")
    with open(path) as f:
        assert json.load(f) == first
    again = _run(tm, "wind_tunnel", num_cal_grid=(20,), seeds=(0, 1), results_path=path)
    assert again["cells"]["num_cal=20/seed=0"] == first["cells"]["num_cal=20/seed=0"]
    _check_cells(again, ["num_cal=20/seed=0", "num_cal=20/seed=1"])
    fresh = _run(tm, "wind_tunnel", num_cal_grid=(20,), seeds=(1,))
    for m in ("c2st", "wasserstein", "mmd"):
        assert fresh["cells"]["num_cal=20/seed=1"][m] == again["cells"]["num_cal=20/seed=1"][m]


def test_summarize_matches_jax():
    rng = np.random.default_rng(0)
    results = {"task": "x", "cells": {
        f"num_cal={n}/seed={s}": {"wall_s": 1.0, "c2st": float(rng.uniform(0.5, 1)),
                                  "wasserstein": float(rng.uniform()), "mmd": float(rng.uniform())}
        for n in (10, 200, 50) for s in range(3)}}
    results["cells"]["num_cal=10/seed=3"] = {"wall_s": 1.0, "c2st": 0.7}  # a cell without w2
    assert th.summarize(results) == jh.summarize(results)


def test_refinement_and_narrow_models_raise(models):
    """Refinement on a task scored by the joint diagnostic raises, as in the
    JAX harness (refinement itself: tests/test_torch_refine.py)."""
    with pytest.raises(ValueError, match="ground-truth sampler"):
        _run(models[1], "sir", num_cal_grid=(20,), seeds=(0,), refine_num_proposals=64)
    cfg = TabICAConfig(d_model=16, num_heads=2, num_layers=1, max_features=8, num_bars=16,
                       dtype="float32")
    narrow = TabICAModel.create(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="max_features"):
        _run(narrow, "bernoulli_glm", num_cal_grid=(20,), seeds=(0,))
