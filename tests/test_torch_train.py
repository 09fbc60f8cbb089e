"""Port parity: pretraining (init, loss, optimizer, loop) vs npe_pfn_tpu's.

- ``init_params`` has the JAX tree, shapes and init scales;
- ``batch_loss`` and its gradients match ``jax.value_and_grad`` of the JAX
  ``batch_loss`` on the same batch and weights (f32; dense and kernel-path
  row attention, remat on and off): loss rtol 1e-5, gradients rtol 1e-4 /
  atol 1e-6;
- the schedule matches ``optax.warmup_cosine_decay_schedule`` (rtol 1e-6),
  and three optimizer updates match the JAX optimizer chain (rtol 1e-5 /
  atol 1e-8);
- ``train`` logs, checkpoints and resumes to the same parameters, bit for
  bit, as an uninterrupted run.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import transformer as jt
from npe_pfn_tpu.pretrain import prior as jprior
from npe_pfn_tpu.pretrain import train as jtrain
from npe_pfn_tpu_torch.models import TabICAConfig, checkpoint, transformer
from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy
from npe_pfn_tpu_torch.pretrain import __main__ as cli
from npe_pfn_tpu_torch.pretrain import prior, train
from npe_pfn_tpu_torch.utils import pytree_io
from torch_parity import flat_params, t

torch.set_num_threads(2)
TINY = dict(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32, dtype="float32")
PCFG = dict(num_features=8, num_ctx=32, num_qry=16, max_active_features=6, hidden=16)


def _jax_params(seed=0, **over):
    cfg = JaxConfig(**{**TINY, **over})
    return cfg, jt.init_params(jax.random.PRNGKey(seed), cfg)


def test_init_params_has_the_jax_tree_shapes_and_scales():
    cfg = TabICAConfig(d_model=64, num_heads=2, num_layers=3, max_features=8, num_bars=64)
    ours = pytree_io.flatten(transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    theirs = flat_params(jt.init_params(jax.random.PRNGKey(0), JaxConfig(**dataclasses.asdict(cfg))))
    assert sorted(ours) == sorted(theirs)
    out_scale = 0.02 / np.sqrt(2.0 * 3 * cfg.num_layers)
    for name, ref in theirs.items():
        got = ours[name]
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32, name
        if np.all(ref == 0) or np.all(ref == 1):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
            continue
        expect = (1.0 if name.startswith("embed/")
                  else out_scale if name.endswith(("/wo", "mlp/w2")) else 0.02)
        # Five standard errors of a sample std: 5 / sqrt(2 n).
        bound = 5 / np.sqrt(2 * ref.size)
        assert abs(got.std().item() / expect - 1) < bound, name
        assert abs(float(np.std(ref)) / expect - 1) < bound, name
    assert transformer.param_count(ours) == sum(a.size for a in theirs.values())


@pytest.mark.parametrize("over", [dict(num_experts=2), dict(row_pool_slots=4)])
def test_init_params_raises_for_unported_options(over):
    cfg = TabICAConfig(**{**TINY, **over})
    with pytest.raises(NotImplementedError):
        transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def _batch(seed=0, num_datasets=2):
    """A numpy task batch (from the port's prior) and its JAX TaskBatch."""
    b = prior.sample_tasks(torch.Generator().manual_seed(seed), num_datasets,
                           prior.PriorConfig(**PCFG))
    arrays = [getattr(b, f.name).numpy() for f in dataclasses.fields(b)]
    return prior.TaskBatch(*(t(a) for a in arrays)), jprior.TaskBatch(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("flash", ["off", "on"])
@pytest.mark.parametrize("remat", [False, True])
def test_batch_loss_and_gradients_match_jax(flash, remat):
    jcfg, jparams = _jax_params(flash=flash, flash_interpret=flash == "on")
    cfg = TabICAConfig(**{**TINY, "flash": flash})
    tbatch, jbatch = _batch()
    borders = jnp.asarray(train.bar.make_borders(cfg.num_bars, cfg.bar_range).numpy())
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtrain.batch_loss(jcfg, borders, p, jbatch, remat))(jparams)
    params = params_from_numpy(flat_params(jparams), "cpu")
    leaves = pytree_io.flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = train.batch_loss(cfg, t(np.asarray(borders)), params, tbatch, remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = flat_params(ref_grads)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4, atol=1e-6, err_msg=name)


def _tcfg(**over):
    return train.TrainConfig(**{**dict(lr=1e-2, warmup_steps=2, max_steps=10, weight_decay=0.1,
                                       b2=0.95, grad_clip=1.0), **over})


def test_schedule_matches_optax():
    tcfg = train.TrainConfig(lr=1.5e-4, warmup_steps=1000, max_steps=24_000)
    ours = train.warmup_cosine_decay_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.max_steps,
                                              end_value=tcfg.lr * 0.05)
    ref = optax.warmup_cosine_decay_schedule(0.0, tcfg.lr, tcfg.warmup_steps, tcfg.max_steps,
                                             tcfg.lr * 0.05)
    counts = [0, 1, 500, 999, 1000, 1001, 12_500, 24_000, 24_010]
    got = [ours(torch.tensor(c, dtype=torch.int32)).item() for c in counts]
    want = [float(ref(jnp.int32(c))) for c in counts]
    assert got[0] == 0.0 == want[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("lr_trunk", [None, 3e-3])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["below_clip", "above_clip"])
def test_three_updates_match_the_jax_optimizer(lr_trunk, grad_scale):
    tcfg = _tcfg(lr_trunk=lr_trunk)
    _, jparams = _jax_params(seed=1)
    opt = jtrain.make_optimizer(jtrain.TrainConfig(**dataclasses.asdict(tcfg)))
    jstate = opt.init(jparams)
    params = params_from_numpy(flat_params(jparams), "cpu")
    ours = train.make_optimizer(tcfg)
    state = ours.init(params)
    rng = np.random.default_rng(0)
    names = sorted(flat_params(jparams))
    for _ in range(3):
        g = {n: (grad_scale * rng.standard_normal(a.shape)).astype(np.float32)
             for n, a in flat_params(jparams).items()}
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), [jnp.asarray(g[n]) for n in names])
        updates, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        upd, state = ours.update(params_from_numpy(g, "cpu"), state, params)
        params = train.apply_updates(params, upd)
    gnorm = train.global_norm(params_from_numpy(g, "cpu")).item()
    assert (gnorm > tcfg.grad_clip) == (grad_scale > 1)
    ref = flat_params(jparams)
    for name, p in pytree_io.flatten(params).items():
        np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-5, atol=1e-8, err_msg=name)


def test_first_update_moves_nothing():
    """The schedule's lr is 0 at update count 0: weights, decay included, stay."""
    _, jparams = _jax_params()
    params = params_from_numpy(flat_params(jparams), "cpu")
    opt = train.make_optimizer(_tcfg())
    grads = pytree_io.unflatten({k: torch.ones_like(v) for k, v in pytree_io.flatten(params).items()})
    upd, state = opt.update(grads, opt.init(params), params)
    assert all(bool((u == 0).all()) for u in pytree_io.flatten(upd).values())
    assert int(state["count"]) == 1


def _tiny_run():
    cfg = TabICAConfig(**TINY)
    tcfg = train.TrainConfig(num_datasets=2, warmup_steps=1, max_steps=4, lr=1e-3,
                             log_every=2, val_every=4, ckpt_every=2)
    return cfg, tcfg, prior.PriorConfig(**PCFG)


def test_train_loop_logs_checkpoints_and_resumes(tmp_path):
    cfg, tcfg, pcfg = _tiny_run()
    full, log = str(tmp_path / "full.npz"), str(tmp_path / "log.jsonl")
    train.train(cfg, tcfg, pcfg, ckpt_path=full, log_path=log, device="cpu")
    recs = [json.loads(line) for line in open(log)]
    losses = [r for r in recs if "loss" in r]
    assert [r["step"] for r in losses] == [2, 4]
    assert all(isinstance(r["loss"], float) and np.isfinite(r["loss"]) for r in losses)
    assert [r["step"] for r in recs if "val_nll" in r] == [4]
    for suffix in ("", ".json", ".train_state.npz", ".train_state.npz.meta.npz"):
        assert (tmp_path / f"full.npz{suffix}").exists()
    assert (tmp_path / "full_best.npz").exists()

    # Stopped by its time limit after step 1, then resumed to 4: the same
    # parameters (the schedule, like optax's, depends on max_steps, so the
    # interrupted run keeps it).
    part = str(tmp_path / "part.npz")
    train.train(cfg, tcfg, pcfg, ckpt_path=part, time_limit_s=1e-9, device="cpu")
    assert int(np.load(part + ".train_state.npz.meta.npz")["step"]) == 1
    train.train(cfg, tcfg, pcfg, ckpt_path=part, device="cpu")
    a = checkpoint.load(full, "cpu").params
    b = checkpoint.load(part, "cpu").params
    b = pytree_io.flatten(b)
    for name, x in pytree_io.flatten(a).items():
        assert torch.equal(x, b[name]), name


def test_entry_points_want_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    cfg, tcfg, pcfg = _tiny_run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(cfg, tcfg, pcfg, ckpt_path=str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--ckpt", str(tmp_path / "m.npz"), "--log", str(tmp_path / "l.jsonl"),
                  "--d_model", "32", "--num_heads", "2", "--num_layers", "2",
                  "--max_features", "8", "--num_bars", "32"])
