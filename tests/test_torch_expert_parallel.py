"""npe_pfn_tpu_torch.parallel.expert_parallel against the JAX package's
ep_place on the same inputs and weights, over 4 gloo ranks: ep 2, ep 4 and
tp×ep 2×2 (attention heads over "tp", experts over "ep"); a model whose
routing ties take a third expert.

f32, rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from npe_pfn_tpu.models import TabICAConfig, TabICAModel, regressor
from npe_pfn_tpu.parallel import ep_place
from npe_pfn_tpu.parallel import ep_pspecs as jax_pspecs
from npe_pfn_tpu_torch.parallel import ep_pspecs
from npe_pfn_tpu_torch.utils import pytree_io
from torch_parallel_ranks import build, ep_body, model_spec, spawn
from torch_parity import flat_params

BASE = dict(d_model=32, num_heads=4, num_layers=2, max_features=4, num_bars=16,
            dtype="float32", num_experts=4, moe_top_k=2)
# (model, mesh shape, axis names, tp axis)
CASES = [("moe", (2, 2), ("rep", "ep"), None), ("moe", (4,), ("ep",), None),
         ("moe", (2, 2), ("tp", "ep"), "tp"), ("tied", (2, 2), ("tp", "ep"), "tp")]


def _model(**over):
    return TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**{**BASE, **over}))


def _tied():
    """Routers with equal columns 1-3: every token ties for its second
    expert and takes three (the ``>=`` rule)."""
    m = _model()
    router = m.params["blocks"]["mlp"]["router"]
    router = router.at[..., 2].set(router[..., 1]).at[..., 3].set(router[..., 1])
    blocks = {**m.params["blocks"], "mlp": {**m.params["blocks"]["mlp"], "router": router}}
    return TabICAModel(cfg=m.cfg, params={**m.params, "blocks": blocks}, borders=m.borders,
                       temperature=m.temperature)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    models = {"moe": _model(), "tied": _tied()}
    rng = np.random.default_rng(3)
    data = dict(x_ctx=rng.normal(size=(64, 4)).astype(np.float32),
                y_ctx=rng.normal(size=(64,)).astype(np.float32),
                x_qry=rng.normal(size=(8, 4)).astype(np.float32))
    bad = {"dense": (model_spec(_model(num_experts=0)), (4,), ("ep",), None),
           "experts": (model_spec(_model(num_experts=2)), (4,), ("ep",), None),
           "heads": (model_spec(_model(num_heads=2)), (4, 1), ("tp", "ep"), "tp")}
    out = spawn(4, ep_body, tmp_path_factory.mktemp("ep"),
                models={k: model_spec(m) for k, m in models.items()}, cases=CASES, bad=bad,
                **data)
    return models, data, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'x'.join(c[2])}")
def test_ep_matches_jax(run, case):
    models, data, out = run
    name, shape, names, tp_axis = case
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    placed = ep_place(mesh, models[name], tp_axis=tp_axis)
    x, y, xq = (jnp.asarray(data[k]) for k in ("x_ctx", "y_ctx", "x_qry"))
    ref = np.asarray(regressor.predict_logits(placed, regressor.fit_encode(placed, x, y), xq))
    for rank_out in out:
        np.testing.assert_allclose(rank_out[case], ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("tp_axis", [None, "tp"])
def test_ep_pspecs_match_jax(tp_axis):
    model = _model()
    ref = flat_params(jax.tree_util.tree_map(
        lambda s: np.array(tuple(s), dtype=object), jax_pspecs(model.params, "ep", tp_axis),
        is_leaf=lambda s: not isinstance(s, dict)))
    flat = pytree_io.flatten(ep_pspecs(build(model_spec(model)).params, "ep", tp_axis))
    assert set(flat) == set(ref)
    for k, spec in flat.items():
        assert tuple(spec) == tuple(ref[k]), k


def test_ep_validation(run):
    errors = run[-1][0]["errors"]
    assert errors["dense"] == "ep_place requires a MoE model (cfg.num_experts > 0)"
    assert errors["experts"] == "ep axis size 4 must divide num_experts=2"
    assert errors["heads"] == "tp axis size 4 must divide num_heads=2"


def test_ep_refuses_grad(run):
    """An ep-placed model's expert combine is reduced without a gradient, so
    under grad it raises rather than hand back partial gradients."""
    for rank_out in run[-1]:
        assert "runs forward only" in rank_out["errors"]["grad"]
