"""The multi-rank dry run: every parallel path on tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip``, with its shapes
(d_model 32, 2 heads, 2 layers, 32 bars, f32) and its branches: a
data-parallel train step and query-sharded sampling at any world size;
dp×sp (gathered and ring), dp×tp and a two-stage pipeline from 4 ranks on;
tp×ep when the world size is a multiple of 4. Each result is held to the
single-device port (rtol 2e-4; atol 2e-5, the ring 2e-4).

    python -c "from npe_pfn_tpu_torch.parallel import dryrun_multichip as d; d(4, 'cpu')"

``dryrun_multichip`` spawns one process per rank (``gloo`` on the CPU,
``nccl`` on CUDA, one card per rank); ``run_rank`` is one rank's body,
which a caller may run in its own process at world size 1.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from .._device import resolve_device

RTOL, ATOL, ATOL_RING = 2e-4, 2e-5, 2e-4


def _close(name, got, ref, atol=ATOL):
    if not torch.allclose(got, ref, rtol=RTOL, atol=atol):
        err = (got - ref).abs().max().item()
        raise AssertionError(f"dryrun_multichip: {name} differs from the single-device port "
                             f"(max |diff| {err:.3e}; rtol {RTOL}, atol {atol})")


def _checks(world: int, dev: torch.device, say) -> None:
    from ..estimator import autoregressive_log_prob
    from ..models import regressor
    from ..models.config import TabICAConfig
    from ..models.regressor import TabICAModel
    from ..pretrain import prior, train
    from ..utils import pytree_io
    from .context_sharded import sp_decode, sp_fit_encode
    from .expert_parallel import ep_place
    from .mesh import get_mesh, make_sharded_train_step, sharded_autoregressive_sample
    from .pipeline import pp_decode, pp_fit_encode
    from .tensor_parallel import tp_forward_logits

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def normal(seed, *shape):
        return torch.randn(shape, generator=gen(seed), device=dev)

    cfg = TabICAConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                       dtype="float32")
    tcfg = train.TrainConfig(num_datasets=2 * world, warmup_steps=2, max_steps=10)
    pcfg = prior.PriorConfig(num_features=8, num_ctx=32, num_qry=16, max_active_features=6,
                             hidden=16)
    model = TabICAModel.create(gen(0), cfg)
    mesh = get_mesh(world, device=dev)
    opt_state = train.make_optimizer(tcfg).init(model.params)

    step, place = make_sharded_train_step(mesh, cfg, tcfg, pcfg)
    params, opt_state = place(model.params, opt_state)
    new, _, loss, gnorm = step(params, opt_state, model.borders, gen(1))
    ref, _, ref_loss, ref_gnorm = train.train_step(cfg, tcfg, pcfg, params, opt_state,
                                                   model.borders, gen(1))
    if not torch.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: non-finite loss {loss}")
    _close("dp loss", loss, ref_loss)
    _close("dp gnorm", gnorm, ref_gnorm)
    ref_flat = pytree_io.flatten(ref)
    for name, t in pytree_io.flatten(new).items():
        _close(f"dp parameter {name}", t, ref_flat[name])
    say(f"dryrun_multichip: dp train step on {world} ranks, loss={loss.item():.4f}")

    n, dth, dx = 64, 2, 3
    theta_ctx, x_ctx = normal(2, n, dth), normal(3, n, dx)
    ctx_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    x_qry = normal(4, 16 * world, dx)
    model2 = dataclasses.replace(model, params=new)
    samples, lps = sharded_autoregressive_sample(mesh, model2, theta_ctx, x_ctx, ctx_mask, x_qry,
                                                 gen(5), qry_chunk=16)
    if samples.shape != (16 * world, dth) or not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"dryrun_multichip: bad samples {tuple(samples.shape)}")
    _close("sharded sampling's log-probs", lps,
           autoregressive_log_prob(model2, theta_ctx, x_ctx, ctx_mask, x_qry, samples, 16))
    say(f"dryrun_multichip: sharded sampling on {world} ranks OK")

    if world < 4 or world % 2:
        return
    kind = dev.type
    x_ctx2, y_ctx2 = normal(6, n, 6), normal(7, n)
    x_q2 = normal(8, 8 * (world // 2), 6)
    ref = regressor.predict_logits(model2, regressor.fit_encode(model2, x_ctx2, y_ctx2), x_q2)
    mesh_sp = init_device_mesh(kind, (world // 2, 2), mesh_dim_names=("data", "sp"))
    for mode, atol in (("gather", ATOL), ("ring", ATOL_RING)):
        fitted = sp_fit_encode(mesh_sp, model2, x_ctx2, y_ctx2, row_attn=mode)
        _close(f"dp×sp ({mode})", sp_decode(mesh_sp, model2, fitted, x_q2, row_attn=mode), ref,
               atol)
    say(f"dryrun_multichip: dp×sp context-sharded forward, gathered and ring, on {world} ranks OK")

    mesh_tp = init_device_mesh(kind, (world // 2, 2), mesh_dim_names=("data", "tp"))
    _close("dp×tp", tp_forward_logits(mesh_tp, model2, x_ctx2, y_ctx2, x_q2, data_axis="data"),
           ref)
    say(f"dryrun_multichip: dp×tp tensor-parallel forward on {world} ranks OK")

    mesh_pp = init_device_mesh(kind, (world // 2, 2), mesh_dim_names=("data", "pp"))
    fitted = pp_fit_encode(mesh_pp, model2, x_ctx2, y_ctx2)
    _close("pp", pp_decode(mesh_pp, model2, fitted, x_q2, num_microbatches=2), ref)
    say("dryrun_multichip: pipeline-parallel forward (2 stages) OK")

    if world % 4:
        return
    model_moe = TabICAModel.create(gen(9), dataclasses.replace(cfg, num_experts=4, moe_top_k=2))
    ref_moe = regressor.predict_logits(model_moe, regressor.fit_encode(model_moe, x_ctx2, y_ctx2),
                                       x_q2)
    mesh_ep = init_device_mesh(kind, (world // 4, 4), mesh_dim_names=("tp", "ep"))
    placed = ep_place(mesh_ep, model_moe, tp_axis="tp")
    _close("tp×ep", regressor.predict_logits(placed, regressor.fit_encode(placed, x_ctx2, y_ctx2),
                                             x_q2), ref_moe)
    say("dryrun_multichip: tp×ep expert-parallel MoE forward OK")


def run_rank(rank: int, world_size: int, init_method: str, device=None) -> None:
    """One rank of the dry run: join the group, run every branch that the
    world size allows (rank 0 prints), leave the group."""
    from .mesh import init_distributed

    dev = init_distributed(rank, world_size, init_method, device)
    try:
        _checks(world_size, dev, print if rank == 0 else (lambda *a: None))
    finally:
        dist.destroy_process_group()


def _spawned(rank, world_size, init_method, device):
    torch.set_num_threads(1)
    run_rank(rank, world_size, init_method, device)


def dryrun_multichip(world_size: int, device=None) -> None:
    """Run the dry run on ``world_size`` spawned ranks: the CPU with
    ``gloo`` for ``device="cpu"``, else one CUDA card per rank with
    ``nccl`` (raises when the host has fewer cards than ranks). A failing
    rank raises here."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, one each; "
                           f"this host has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_spawned, args=(world_size, init, dev.type), nprocs=world_size, join=True)

