"""Process groups, meshes, data-parallel pretraining and query-sharded sampling.

Counterpart of ``npe_pfn_tpu/parallel/mesh.py`` on ``torch.distributed``. A
JAX ``Mesh`` with named axes becomes a ``DeviceMesh`` with the same axis
names (``"data"``, ``"sp"``, ``"tp"``, ``"pp"``, ``"ep"``); every function of
``npe_pfn_tpu_torch.parallel`` takes the mesh and reads an axis's process
group with ``mesh.get_group(axis)``. Where JAX returns a global array, every
rank here returns the whole result (gathered in rank order).

- **Data-parallel pretraining**: each rank takes the loss and gradients of
  its contiguous share of the step's datasets; one ``all_reduce`` over a
  flat bucket averages the gradients (and the loss); parameters stay
  replicated, every rank applying the same update.
- **Query-sharded sampling**: each rank samples its contiguous share of the
  query rows against the replicated context, with no collective until the
  rows are gathered at the end.

One process drives one device: ``cuda:{rank}`` with the ``nccl`` backend
(the default), or the CPU with ``gloo``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import resolve_device
from ..models.config import TabICAConfig
from ..models.regressor import TabICAModel
from ..pretrain import prior
from ..pretrain import train as train_mod
from ..utils import pytree_io
from ..utils.seeding import derive_seed


def init_distributed(rank: int, world_size: int, init_method: str, device=None) -> torch.device:
    """Join a process group of ``world_size`` ranks on this host; returns the
    rank's device.

    CUDA (``device=None``) takes ``cuda:{rank}`` and the ``nccl`` backend, and
    raises when the host has fewer cards than ranks (NCCL takes one card per
    rank); ``device="cpu"`` takes ``gloo``. ``init_method`` is a ``file://``
    path or ``tcp://localhost:<port>``. A failed ``init_process_group``
    raises to the caller."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, one each; "
                               f"this host has {torch.cuda.device_count()}")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    # Bound to its card, NCCL builds its communicator here, not in the first
    # collective of whatever runs next.
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=dev if dev.type == "cuda" else None)
    return dev


def get_mesh(n: Optional[int] = None, axis: str = "data", device=None) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over every rank of the initialised process
    group; its device type is CUDA unless ``device`` says otherwise."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: the mesh "
                         f"spans every rank")
    return init_device_mesh(resolve_device(device).type, (world,), mesh_dim_names=(axis,))


def has_axis(mesh: DeviceMesh, axis: Optional[str]) -> bool:
    return axis is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_slice(mesh: DeviceMesh, axis: str, n: int, what: str) -> slice:
    """This rank's contiguous share of ``n`` items split over ``axis``."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{what} {n} must divide over the {size} ranks of axis {axis!r}")
    per = n // size
    r = mesh.get_local_rank(axis)
    return slice(r * per, (r + 1) * per)


def gather(x, mesh: DeviceMesh, axis: str, dim: int = 0):
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in rank
    order (one ``all_gather``, also at one rank)."""
    group = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_batch(mesh: DeviceMesh, batch, axis: str = "data"):
    """This rank's contiguous slice of the leading dataset axis of a
    ``prior.TaskBatch`` (or of a tensor)."""
    if isinstance(batch, torch.Tensor):
        return batch[axis_slice(mesh, axis, batch.shape[0], "datasets")]
    return dataclasses.replace(batch, **{f.name: shard_batch(mesh, getattr(batch, f.name), axis)
                                         for f in dataclasses.fields(batch)})


def averaged_loss_and_grads(mesh: DeviceMesh, cfg: TabICAConfig, tcfg: train_mod.TrainConfig,
                            params, borders, local, axis: str = "data"):
    """``batch_loss`` of this rank's share of the datasets and its gradients
    (a tree like ``params``, whose leaves require grad), averaged over
    ``axis`` with one ``all_reduce`` of a flat bucket: with equal shares,
    the whole batch's loss and gradients, the same on every rank."""
    flat = pytree_io.flatten(params)
    with torch.enable_grad():
        loss = train_mod.batch_loss(cfg, borders, params, local,
                                    moe_aux_weight=tcfg.moe_aux_weight)
        grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        bucket = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1)])
        dist.all_reduce(bucket, group=mesh.get_group(axis))
        bucket /= axis_size(mesh, axis)
        parts = bucket[:-1].split([g.numel() for g in grads])
        grads = pytree_io.unflatten({name: part.view_as(g).to(g.dtype)
                                     for name, part, g in zip(flat, parts, grads)})
    return bucket[-1], grads


def make_sharded_train_step(
    mesh: DeviceMesh,
    cfg: TabICAConfig,
    tcfg: train_mod.TrainConfig,
    pcfg: prior.PriorConfig,
    axis: str = "data",
):
    """Data-parallel train step: datasets sharded, parameters replicated.

    Returns ``(step, place)``. ``step(params, opt_state, borders, generator,
    batch=None)`` returns ``(params, opt_state, loss, gnorm)``
    like ``train.train_step``. Draw rule: without ``batch`` every rank draws
    the step's whole batch of ``tcfg.num_datasets`` tasks from ``generator``
    (seed it alike on every rank), as JAX draws one batch from the step key
    and shards it, and keeps its contiguous share (so each rank pays the
    whole batch's prior draw); a given ``batch`` is the whole batch and is
    sharded the same way. The gradients and the loss are
    averaged with one ``all_reduce`` over a flat bucket, so the global-norm
    clip and the reported ``loss`` and ``gnorm`` are the global ones. Shares
    are equal, so the mean of the ranks' losses (each a mean over its
    datasets, the MoE aux included) is the whole batch's.
    ``place(params, opt_state)`` broadcasts both from the axis's first rank,
    so that every rank starts from the same state.
    """
    n = axis_size(mesh, axis)
    if tcfg.num_datasets % n:
        raise ValueError(f"num_datasets {tcfg.num_datasets} must divide over the {n} ranks "
                         f"of axis {axis!r}")
    group = mesh.get_group(axis)
    src = dist.get_process_group_ranks(group)[0]
    opt = train_mod.make_optimizer(tcfg)

    def step(params, opt_state, borders, generator, batch=None):
        if batch is None:
            batch = prior.sample_tasks(generator, tcfg.num_datasets, pcfg)
        params = train_mod._tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, grads = averaged_loss_and_grads(mesh, cfg, tcfg, params, borders,
                                              shard_batch(mesh, batch, axis), axis)
        with torch.no_grad():
            gnorm = train_mod.global_norm(grads)
            updates, opt_state = opt.update(grads, opt_state, params, gnorm)
            params = train_mod.apply_updates(train_mod._tree_map(torch.Tensor.detach, params),
                                             updates)
        return params, opt_state, loss, gnorm

    def place(params, opt_state):
        for t in list(pytree_io.flatten(params).values()) + list(
                pytree_io.flatten(opt_state).values()):
            dist.broadcast(t, src=src, group=group)
        return params, opt_state

    return step, place


@torch.no_grad()
def sharded_autoregressive_sample(
    mesh: DeviceMesh,
    model: TabICAModel,
    theta_ctx,
    x_ctx,
    ctx_mask,
    x_qry,
    generator: torch.Generator,
    qry_chunk: int = 1024,
    axis: str = "data",
    target_transform: str = "zscore",
):
    """Posterior sampling with the query rows sharded over ``axis``.

    Rank r samples query rows ``[r·Q/n, (r+1)·Q/n)`` with
    ``estimator.autoregressive_sample`` against the replicated context, in
    chunks of ``min(qry_chunk, Q/n)`` rows, and no collective runs until the
    rows and their log-probs are all-gathered in rank order: every rank
    returns ``(theta [Q, dθ], log_prob [Q])``.

    Generators: at one rank the caller's ``generator`` draws everything, so
    the result equals ``autoregressive_sample``'s bit for bit. At n > 1 ranks
    each rank draws one integer from the caller's generator (seed it alike on
    every rank) and samples from a generator of its own seeded
    ``derive_seed(that integer, rank)``: the ranks draw independent streams.
    JAX splits no key per device, so the two packages agree in distribution
    only.
    """
    from ..estimator import autoregressive_sample

    n = axis_size(mesh, axis)
    rows = axis_slice(mesh, axis, x_qry.shape[0], "query rows")
    gen = generator
    if n > 1:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        gen = torch.Generator(x_qry.device).manual_seed(
            derive_seed(seed, mesh.get_local_rank(axis)))
    theta, lp = autoregressive_sample(model, theta_ctx, x_ctx, ctx_mask, x_qry[rows], gen,
                                      min(qry_chunk, rows.stop - rows.start), target_transform)
    return gather(theta, mesh, axis), gather(lp, mesh, axis)
