"""npe_pfn_tpu_torch.parallel.pipeline against the JAX package's
pp_fit_encode / pp_decode on the same inputs and weights: 2 gloo ranks as 2
stages of a 4-layer model, 1 and 2 microbatches, a context mask; the
row-pooled and the MoE model through the same stages.

f32, rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from npe_pfn_tpu.models import TabICAConfig, TabICAModel
from npe_pfn_tpu.parallel import pp_decode, pp_fit_encode
from torch_parallel_ranks import model_spec, pp_body, spawn

BASE = dict(d_model=32, num_heads=2, max_features=8, num_bars=32, dtype="float32")
CONFIGS = {"dense": dict(num_layers=4), "pooled": dict(num_layers=2, row_pool_slots=4),
           "moe": dict(num_layers=2, num_experts=4, moe_top_k=2)}
CASES = [("dense", 1), ("dense", 2), ("pooled", 2), ("moe", 2)]


def _model(**over):
    return TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**BASE, **over))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    models = {k: _model(**v) for k, v in CONFIGS.items()}
    rng = np.random.default_rng(2)
    data = dict(x_ctx=rng.normal(size=(40, 3)).astype(np.float32),
                y_ctx=rng.normal(size=(40,)).astype(np.float32),
                x_qry=rng.normal(size=(24, 3)).astype(np.float32),
                ctx_mask=np.arange(40) < 29)
    out = spawn(2, pp_body, tmp_path_factory.mktemp("pp"),
                models={k: model_spec(m) for k, m in models.items()}, cases=CASES,
                three_layers=model_spec(_model(num_layers=3)), **data)
    return models, data, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-mb{c[1]}")
def test_pp_matches_jax(run, case):
    models, data, out = run
    name, mbs = case
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    model = models[name]
    fitted = pp_fit_encode(mesh, model, jnp.asarray(data["x_ctx"]), jnp.asarray(data["y_ctx"]),
                           ctx_mask=jnp.asarray(data["ctx_mask"]))
    ref = np.asarray(pp_decode(mesh, model, fitted, jnp.asarray(data["x_qry"]),
                               num_microbatches=mbs))
    for rank_out in out:
        np.testing.assert_allclose(rank_out[case], ref, rtol=2e-4, atol=2e-5)


def test_pp_validation(run):
    out = run[-1][0]
    assert out["layers"] == "num_layers 3 must divide pp axis 2"
    assert out["microbatches"] == "query rows 23 must divide microbatches 2"
