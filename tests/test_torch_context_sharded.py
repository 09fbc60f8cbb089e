"""npe_pfn_tpu_torch.parallel.context_sharded against the JAX package's
sp_fit_encode / sp_decode on the same inputs and weights: gathered and ring
row attention over 2 and 4 gloo ranks (sp 2 alone, dp×sp 2×2, sp 4), with
context masks that differ between shards and leave one shard fully masked.

f32; gather rtol 2e-4 / atol 2e-5, ring atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from npe_pfn_tpu.models import TabICAConfig, TabICAModel
from npe_pfn_tpu.parallel.context_sharded import sp_decode, sp_fit_encode
from torch_parallel_ranks import model_spec, sp_body, spawn

CFG = dict(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=16, dtype="float32")
N, Q = 64, 24


def _masks():
    """A: rows 16-31 masked (sp 4's second shard) and a quarter of the rest;
    B: rows 32-63 masked (sp 2's second shard) and a quarter of rows 0-31."""
    rng = np.random.default_rng(1)
    a = rng.random(N) > 0.25
    a[16:32] = False
    b = rng.random(N) > 0.25
    b[32:] = False
    return {"A": a, "B": b}


# (mesh shape, axis names, data axis, row attention, mask)
CASES = [((2, 2), ("data", "sp"), "data", mode, mask)
         for mode in ("gather", "ring") for mask in ("A", "B")]
CASES += [((4,), ("sp",), None, mode, mask) for mode in ("gather", "ring") for mask in ("A", "B")]
CASES += [((2, 2), ("rep", "sp"), None, mode, "A") for mode in ("gather", "ring")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    model = TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**CFG))
    pooled = TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**CFG, row_pool_slots=4))
    rng = np.random.default_rng(0)
    data = dict(x_ctx=rng.normal(size=(N, 8)).astype(np.float32),
                y_ctx=rng.normal(size=(N,)).astype(np.float32),
                x_qry=rng.normal(size=(Q, 8)).astype(np.float32))
    masks = _masks()
    out = spawn(4, sp_body, tmp_path_factory.mktemp("sp"), model=model_spec(model),
                pooled=model_spec(pooled), masks=masks, cases=CASES, **data)
    return model, data, masks, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[1:])))
def test_sp_matches_jax(run, case):
    model, data, masks, out = run
    shape, names, data_axis, mode, mask = case
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    fitted = sp_fit_encode(mesh, model, jnp.asarray(data["x_ctx"]), jnp.asarray(data["y_ctx"]),
                           ctx_mask=jnp.asarray(masks[mask]), row_attn=mode)
    ref = np.asarray(sp_decode(mesh, model, fitted, jnp.asarray(data["x_qry"]),
                               data_axis=data_axis, row_attn=mode))
    atol = 2e-4 if mode == "ring" else 2e-5
    for rank_out in out:
        np.testing.assert_allclose(rank_out[case], ref, rtol=2e-4, atol=atol)


def test_sp_validation(run):
    out = run[-1][0]
    assert "JAX's sharded block ignores row_pool_slots" in out["pooled"]
    assert "row_attn must be one of ('gather', 'ring'), got 'tree'" in out["mode"]
    assert "context rows 63 must divide over the 2 ranks of axis 'sp'" in out["rows"]
