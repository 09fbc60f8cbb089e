"""Rank bodies of the parallel parity tests, and the spawner that runs them.

Every body runs in a process of its own, started with ``spawn`` and joined to
a ``gloo`` group through a ``file://`` rendezvous under the test's tmp_path
(fixed TCP ports would collide between test workers). This module imports
nothing of JAX, so the ranks never load it: the test files compute the JAX
side in the pytest process and hand the port's inputs and weights to the
ranks as numpy arrays. A body returns a dict of numpy arrays and strings;
``spawn`` returns each rank's.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh


def model_spec(jax_model, **cfg_over):
    """What a rank needs to build the port's copy of a JAX model (numpy)."""
    import dataclasses

    from torch_parity import flat_params

    return dict(cfg={**dataclasses.asdict(jax_model.cfg), **cfg_over},
                params=flat_params(jax_model.params), borders=np.asarray(jax_model.borders),
                temperature=float(np.asarray(jax_model.temperature)))


def build(spec):
    from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
    from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy

    return TabICAModel(cfg=TabICAConfig(**spec["cfg"]),
                       params=params_from_numpy(spec["params"], "cpu"),
                       borders=torch.tensor(spec["borders"]), temperature=spec["temperature"])


def spawn(world, body, tmp_path, **kwargs):
    """``body(rank, world, **kwargs)`` on ``world`` spawned gloo ranks; the
    list of their results. The inputs go through a file: arguments larger
    than a pipe's buffer would make each start wait for the previous child
    to import torch."""
    d = str(tmp_path)
    torch.save(kwargs, os.path.join(d, "inputs.pt"))
    mp.spawn(_child, args=(world, body, "file://" + os.path.join(d, "rendezvous"), d),
             nprocs=world, join=True)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _child(rank, world, body, init, d):
    from npe_pfn_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    kwargs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    init_distributed(rank, world, init, "cpu")
    try:
        out = body(rank, world, **kwargs)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.detach().numpy().copy()


def _error(fn, kind=ValueError):
    """The message of the ``kind`` error ``fn()`` raises ("" if none)."""
    try:
        fn()
    except kind as exc:
        return str(exc)
    return ""


def _grad_error(place, model, x_ctx, y_ctx, x_qry):
    """The RuntimeError of the training forward under grad through
    ``place(model)``, whose parameters require grad ("" if none)."""
    from npe_pfn_tpu_torch.models import transformer
    from npe_pfn_tpu_torch.utils import pytree_io

    for t in pytree_io.flatten(model.params).values():
        t.requires_grad_(True)
    placed = place(model)
    return _error(lambda: transformer.forward(placed.cfg, placed.params, x_ctx, y_ctx, x_qry),
                  RuntimeError)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- mesh.py: data-parallel step and query-sharded sampling ----------------


def dp_body(rank, world, models, tcfg, pcfg, seeds):
    """Per model: the dp-averaged loss and gradients of the first seed's
    batch; two dp steps and two single-device ``train_step``s on the
    seeds' batches (loss, gnorm, parameters after each)."""
    from npe_pfn_tpu_torch.parallel import get_mesh, make_sharded_train_step, shard_batch
    from npe_pfn_tpu_torch.parallel.mesh import averaged_loss_and_grads
    from npe_pfn_tpu_torch.pretrain import prior, train
    from npe_pfn_tpu_torch.utils import pytree_io

    mesh = get_mesh(world, device="cpu")
    tcfg, pcfg = train.TrainConfig(**tcfg), prior.PriorConfig(**pcfg)
    out = {}
    for name, spec in models.items():
        m = build(spec)
        batch = prior.sample_tasks(_gen(seeds[0]), tcfg.num_datasets, pcfg)
        params = train._tree_map(lambda x: x.detach().requires_grad_(True), m.params)
        loss, grads = averaged_loss_and_grads(mesh, m.cfg, tcfg, params, m.borders,
                                              shard_batch(mesh, batch))
        out[name] = dict(loss=loss.item(),
                         grads={k: _np(g) for k, g in pytree_io.flatten(grads).items()})
        step, place = make_sharded_train_step(mesh, m.cfg, tcfg, pcfg)
        opt_state = train.make_optimizer(tcfg).init(m.params)
        dp = place(m.params, opt_state)
        one = (m.params, opt_state)
        for i, seed in enumerate(seeds):
            p, s, loss, gnorm = step(*dp, m.borders, _gen(seed))
            dp = (p, s)
            p1, s1, loss1, gnorm1 = train.train_step(m.cfg, tcfg, pcfg, *one, m.borders,
                                                     _gen(seed))
            one = (p1, s1)
            out[name][f"step{i}"] = dict(
                dp=(loss.item(), gnorm.item(), {k: _np(v) for k, v in pytree_io.flatten(p).items()}),
                single=(loss1.item(), gnorm1.item(),
                        {k: _np(v) for k, v in pytree_io.flatten(p1).items()}))
    m = build(next(iter(models.values())))
    out["errors"] = dict(
        datasets=_error(lambda: make_sharded_train_step(
            mesh, m.cfg, train.TrainConfig(num_datasets=2 * world + 1), pcfg)),
        mesh_size=_error(lambda: get_mesh(world + 1, device="cpu")))
    return out


def sample_body(rank, world, model, theta_ctx, x_ctx, ctx_mask, x_qry, seed):
    """Sharded sampling over all ranks; at one rank of a ("rep", "data")
    mesh, the same call against ``autoregressive_sample`` on the caller's
    generator."""
    from npe_pfn_tpu_torch.estimator import autoregressive_sample
    from npe_pfn_tpu_torch.parallel import get_mesh, sharded_autoregressive_sample

    m = build(model)
    args = (_t(theta_ctx), _t(x_ctx), _t(ctx_mask), _t(x_qry))
    mesh = get_mesh(world, device="cpu")
    samples, lps = sharded_autoregressive_sample(mesh, m, *args, _gen(seed), qry_chunk=16)
    mesh1 = init_device_mesh("cpu", (world, 1), mesh_dim_names=("rep", "data"))
    one = sharded_autoregressive_sample(mesh1, m, *args, _gen(seed), qry_chunk=16)
    ref = autoregressive_sample(m, *args, _gen(seed), 16)
    return dict(samples=_np(samples), lps=_np(lps), one=[_np(a) for a in one],
                ref=[_np(a) for a in ref],
                odd_rows=_error(lambda: sharded_autoregressive_sample(
                    mesh, m, *args[:3], args[3][:world + 1], _gen(seed), qry_chunk=16)))


# --- context_sharded.py -----------------------------------------------------


def sp_body(rank, world, model, pooled, x_ctx, y_ctx, x_qry, masks, cases):
    """``sp_fit_encode`` + ``sp_decode`` for each case ``(shape, names,
    data_axis, mode, mask)``; the errors of a pooled model and a bad mode."""
    from npe_pfn_tpu_torch.parallel.context_sharded import sp_decode, sp_fit_encode

    m = build(model)
    x_ctx, y_ctx, x_qry = _t(x_ctx), _t(y_ctx), _t(x_qry)
    meshes = {}
    out = {}
    for shape, names, data_axis, mode, mask in cases:
        if (shape, names) not in meshes:
            meshes[shape, names] = init_device_mesh("cpu", shape, mesh_dim_names=names)
        mesh = meshes[shape, names]
        fitted = sp_fit_encode(mesh, m, x_ctx, y_ctx, ctx_mask=_t(masks[mask]), row_attn=mode)
        logits = sp_decode(mesh, m, fitted, x_qry, data_axis=data_axis, row_attn=mode)
        out[shape, names, data_axis, mode, mask] = _np(logits)
    mesh = next(iter(meshes.values()))
    out["pooled"] = _error(lambda: sp_fit_encode(mesh, build(pooled), x_ctx, y_ctx))
    out["mode"] = _error(lambda: sp_fit_encode(mesh, m, x_ctx, y_ctx, row_attn="tree"))
    out["rows"] = _error(lambda: sp_fit_encode(mesh, m, x_ctx[:-1], y_ctx[:-1]))
    return out


# --- tensor_parallel.py -----------------------------------------------------


def tp_body(rank, world, models, x_ctx, y_ctx, x_qry, cases, sample, seed, bad):
    """``tp_forward_logits`` for each case ``(model, shape, names,
    data_axis)``; ``autoregressive_sample`` through a tp-placed model and the
    replicated one on the same generator; ``tp_place``'s errors, and the
    refusal of a placed model under grad."""
    from npe_pfn_tpu_torch.estimator import autoregressive_sample
    from npe_pfn_tpu_torch.parallel import tp_forward_logits, tp_place

    built = {k: build(v) for k, v in models.items()}
    x_ctx, y_ctx, x_qry = _t(x_ctx), _t(y_ctx), _t(x_qry)
    out = {}
    for name, shape, names, data_axis in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out[name, shape, names, data_axis] = _np(tp_forward_logits(
            mesh, built[name], x_ctx, y_ctx, x_qry, data_axis=data_axis))
    name, shape, names = sample["model"], sample["shape"], sample["names"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    args = [_t(sample[k]) for k in ("theta_ctx", "x_ctx", "ctx_mask", "x_qry")]
    placed = tp_place(mesh, built[name])
    out["sample_tp"] = [_np(a) for a in autoregressive_sample(placed, *args, _gen(seed), 16)]
    out["sample_one"] = [_np(a) for a in autoregressive_sample(built[name], *args, _gen(seed), 16)]
    out["errors"] = {k: _error(lambda: tp_place(mesh, build(v))) for k, v in bad.items()}
    out["errors"]["grad"] = _grad_error(lambda m: tp_place(mesh, m), build(models[name]),
                                        x_ctx, y_ctx, x_qry)
    return out


# --- pipeline.py ------------------------------------------------------------


def pp_body(rank, world, models, x_ctx, y_ctx, x_qry, ctx_mask, cases, three_layers):
    """``pp_fit_encode`` + ``pp_decode`` on a ("pp",) mesh of every rank for
    each case ``(model, num_microbatches)``; the errors."""
    from npe_pfn_tpu_torch.parallel import get_mesh, pp_decode, pp_fit_encode

    mesh = get_mesh(world, axis="pp", device="cpu")
    x_ctx, y_ctx, x_qry, ctx_mask = _t(x_ctx), _t(y_ctx), _t(x_qry), _t(ctx_mask)
    out = {}
    for name, mbs in cases:
        m = build(models[name])
        fitted = pp_fit_encode(mesh, m, x_ctx, y_ctx, ctx_mask=ctx_mask)
        out[name, mbs] = _np(pp_decode(mesh, m, fitted, x_qry, num_microbatches=mbs))
    m = build(models[cases[0][0]])
    fitted = pp_fit_encode(mesh, m, x_ctx, y_ctx)
    out["layers"] = _error(lambda: pp_fit_encode(mesh, build(three_layers), x_ctx, y_ctx))
    out["microbatches"] = _error(lambda: pp_decode(mesh, m, fitted, x_qry[:-1], 2))
    return out


# --- expert_parallel.py -----------------------------------------------------


def ep_body(rank, world, models, x_ctx, y_ctx, x_qry, cases, bad):
    """``fit_encode`` + ``predict_logits`` through ``ep_place`` for each case
    ``(model, shape, names, tp_axis)``; ``ep_place``'s errors, and the
    refusal of a placed model under grad."""
    from npe_pfn_tpu_torch.models import regressor
    from npe_pfn_tpu_torch.parallel import ep_place

    x_ctx, y_ctx, x_qry = _t(x_ctx), _t(y_ctx), _t(x_qry)
    out = {}
    for name, shape, names, tp_axis in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        placed = ep_place(mesh, build(models[name]), tp_axis=tp_axis)
        out[name, shape, names, tp_axis] = _np(
            regressor.predict_logits(placed, regressor.fit_encode(placed, x_ctx, y_ctx), x_qry))
    out["errors"] = {}
    for key, (spec, shape, names, tp_axis) in bad.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out["errors"][key] = _error(lambda: ep_place(mesh, build(spec), tp_axis=tp_axis))
    name, shape, names, tp_axis = cases[0]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    out["errors"]["grad"] = _grad_error(lambda m: ep_place(mesh, m, tp_axis=tp_axis),
                                        build(models[name]), x_ctx, y_ctx, x_qry)
    return out
