"""Pretraining loop for TabICA on the synthetic task prior.

Counterpart of ``npe_pfn_tpu/pretrain/train.py``. Every step samples fresh
tasks on the device (``prior.sample_tasks``), takes the gradient of the mean
query-row NLL in context-normalized target space (``batch_loss``) and applies
the JAX package's optimizer: ``optax.chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))``, optionally with separate "head" and
"trunk" learning rates. ``torch.optim`` differs from optax in three places
that matter here (the schedule's lr 0 at the first update, weight decay on
every leaf, the clip without +1e-6), so the optimizer is written out below.

Row attention runs through the CUDA kernels on a card: the lse forward and the
backward of ``flash_row_attention_trainable`` under grad, the inference
forward in ``eval_step``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models import bar_distribution as bar
from ..models import checkpoint as ckpt_mod
from ..models import regressor, transformer
from ..models.config import TabICAConfig
from ..models.regressor import TabICAModel
from ..utils import pytree_io
from ..utils.seeding import derive_seed
from . import prior


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_datasets: int = 32          # tasks per step
    lr: float = 3e-4
    warmup_steps: int = 2000
    max_steps: int = 200_000
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    b2: float = 0.95
    seed: int = 0
    val_every: int = 500
    ckpt_every: int = 2000
    log_every: int = 100
    # Warm-restart refinement: when set, the trunk trains at this peak lr and
    # the bar head at `lr`.
    lr_trunk: Optional[float] = None
    # Feature-count curriculum: when steps > 0, the active-feature cap ramps
    # linearly from `feat_curriculum_init` to pcfg.max_active_features.
    feat_curriculum_steps: int = 0
    feat_curriculum_init: int = 8
    # Weight of the MoE load-balance aux loss (cfg.num_experts > 0 only).
    moe_aux_weight: float = 0.01


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in pytree_io.flatten(tree).values()))


def warmup_cosine_decay_schedule(peak: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule`` with ``init_value`` 0 and
    exponent 1, as a function of an integer count tensor; f32 arithmetic, no
    host sync. The value at count 0 is 0."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine part needs positive decay steps, got {decay_steps - warmup_steps}")
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count):
        c = torch.as_tensor(count).to(torch.float32)
        cc = torch.clamp(c - warmup_steps, max=cos_steps)
        cosine = peak * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * cc / cos_steps))) + alpha)
        if warmup_steps <= 0:
            return cosine
        frac = 1 - torch.clamp(c, 0, warmup_steps) / warmup_steps
        warm = -peak * frac + peak
        return torch.where(c < warmup_steps, warm, cosine)

    return schedule


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b2=b2,
    weight_decay=weight_decay))`` (b1 0.9, eps 1e-8 outside the square
    root), or with ``lr_trunk`` the optax ``multi_transform`` of two such
    AdamWs over the "head" subtree and the rest ("trunk"). ``init`` and
    ``update`` mirror optax's; ``update`` returns ``(updates, state)`` and
    ``apply_updates`` adds them. Nothing here syncs with the host."""

    b1 = 0.9
    eps = 1e-8

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg

        def sched(peak):
            return warmup_cosine_decay_schedule(peak, tcfg.warmup_steps, tcfg.max_steps,
                                                end_value=peak * 0.05)

        if tcfg.lr_trunk is None:
            self.schedules = {None: sched(tcfg.lr)}
        else:
            self.schedules = {"head": sched(tcfg.lr), "trunk": sched(tcfg.lr_trunk)}

    @staticmethod
    def _split(tree, group):
        if group is None:
            return tree
        if group == "head":
            return {"head": tree["head"]}
        return {k: v for k, v in tree.items() if k != "head"}

    def init(self, params) -> dict:
        def adam_state(sub):
            dev = next(iter(pytree_io.flatten(sub).values())).device
            return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": _tree_map(torch.zeros_like, sub),
                    "nu": _tree_map(torch.zeros_like, sub)}

        if None in self.schedules:
            return adam_state(params)
        return {g: adam_state(self._split(params, g)) for g in self.schedules}

    def update(self, grads, state, params, gnorm=None):
        max_norm = self.tcfg.grad_clip
        if gnorm is None:
            gnorm = global_norm(grads)
        keep = gnorm < max_norm
        grads = _tree_map(lambda g: torch.where(keep, g, (g / gnorm) * max_norm), grads)
        b1, b2, eps, wd = self.b1, self.tcfg.b2, self.eps, self.tcfg.weight_decay
        updates, new_state = {}, {}
        for group, sched in self.schedules.items():
            st = state if group is None else state[group]
            g_sub, p_sub = self._split(grads, group), self._split(params, group)
            count = st["count"]
            count_inc = count + 1
            c = count_inc.to(torch.float32)
            bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
            bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
            step_size = -sched(count)
            mu = _tree_map(lambda g, m: (1 - b1) * g + b1 * m, g_sub, st["mu"])
            nu = _tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, g_sub, st["nu"])

            def leaf_update(m, v, p):
                u = (m / bc1) / (torch.sqrt(v / bc2 + 0.0) + eps)
                return step_size * (u + wd * p)

            upd = _tree_map(leaf_update, mu, nu, p_sub)
            group_state = {"count": count_inc, "mu": mu, "nu": nu}
            if group is None:
                return upd, group_state
            updates.update(upd)
            new_state[group] = group_state
        return updates, new_state


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return Optimizer(tcfg)


def apply_updates(params, updates):
    """``optax.apply_updates``: new parameter tensors ``p + u``."""
    return _tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def batch_loss(cfg: TabICAConfig, borders, params, batch: prior.TaskBatch,
               remat: bool = True, moe_aux_weight: float = 0.01):
    """Mean query-row NLL in context-normalized target space, plus, for a
    MoE model (``cfg.num_experts > 0``), ``moe_aux_weight`` times the mean
    over datasets of each dataset's load-balance aux loss (the JAX package
    computes the aux per dataset under its vmap; the aux is not linear in
    the routing statistics, so one mean over every dataset's tokens would
    differ). Each dataset is normalized by its own masked context
    statistics; normalized query targets are clipped to ``±cfg.bar_range``."""
    stats = regressor.compute_stats(batch.x_ctx, batch.y_ctx, batch.ctx_mask)
    fm = batch.feat_mask[:, None, :]
    xn_c = regressor.normalize_x(stats, batch.x_ctx) * fm
    yn_c = regressor.normalize_y(stats, batch.y_ctx) * batch.ctx_mask
    xn_q = regressor.normalize_x(stats, batch.x_qry) * fm
    yn_q = regressor.normalize_y(stats, batch.y_qry).clamp(-cfg.bar_range, cfg.bar_range)
    moe = cfg.num_experts > 0
    out = transformer.forward(cfg, params, xn_c, yn_c, xn_q, batch.feat_mask,
                              batch.ctx_mask, remat, with_moe_aux=moe)
    logits, aux = out if moe else (out, None)
    loss = bar.nll(borders, logits, yn_q).mean()
    if moe:
        loss = loss + moe_aux_weight * aux.mean()
    return loss


def train_step(cfg: TabICAConfig, tcfg: TrainConfig, pcfg: prior.PriorConfig, params,
               opt_state, borders, generator: torch.Generator, max_feat=None):
    """One step: sample ``tcfg.num_datasets`` tasks from ``generator``, take
    the loss and its gradient, update. Returns ``(params, opt_state, loss,
    gnorm)`` (new parameter tensors; ``gnorm`` is the gradient's global norm
    before the clip), all on the device, with no host sync."""
    batch = prior.sample_tasks(generator, tcfg.num_datasets, pcfg, max_feat)
    params = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = pytree_io.flatten(params)
    with torch.enable_grad():
        loss = batch_loss(cfg, borders, params, batch, moe_aux_weight=tcfg.moe_aux_weight)
        grads = torch.autograd.grad(loss, list(flat.values()))
    grads = pytree_io.unflatten(dict(zip(flat, grads)))
    with torch.no_grad():
        gnorm = global_norm(grads)
        updates, opt_state = make_optimizer(tcfg).update(grads, opt_state, params, gnorm)
        params = apply_updates(_tree_map(torch.Tensor.detach, params), updates)
    return params, opt_state, loss.detach(), gnorm


@torch.no_grad()
def eval_step(cfg: TabICAConfig, params, pcfg: prior.PriorConfig, borders, seed: int,
              num_batches: int = 4):
    """Validation NLL averaged over ``num_batches`` fixed 32-task batches;
    batch ``i`` is drawn from the seed ``derive_seed(seed, i)``. Pure NLL,
    no MoE aux term. A 0-d tensor on the device."""
    total = None
    for i in range(num_batches):
        gen = torch.Generator(borders.device).manual_seed(derive_seed(seed, i))
        batch = prior.sample_tasks(gen, 32, pcfg)
        loss = batch_loss(cfg, borders, params, batch, remat=False, moe_aux_weight=0.0)
        total = loss if total is None else total + loss
    return total / num_batches


def train(
    cfg: TabICAConfig,
    tcfg: TrainConfig,
    pcfg: prior.PriorConfig,
    ckpt_path: str,
    resume: bool = True,
    log_path: Optional[str] = None,
    time_limit_s: Optional[float] = None,
    init_from: Optional[str] = None,
    profile_steps: int = 0,
    profile_dir: Optional[str] = None,
    device=None,
) -> TabICAModel:
    """Full pretraining run with atomic checkpointing and resume.

    Runs on CUDA unless ``device`` says otherwise (and raises without a
    card). ``init_from`` warm-starts the params from another checkpoint
    (trunk copied, bar head upsampled), used only when no resume state exists
    for ``ckpt_path``. Step ``s`` draws its tasks from the seed
    ``derive_seed(tcfg.seed, s)``, so a resumed run continues the stream. The
    loss is summed on the device; the host reads it only at the log cadence.
    ``profile_steps`` traces that many steps after the first with
    ``torch.profiler`` into ``profile_dir``.
    """
    device = resolve_device(device)
    init_gen = torch.Generator(device).manual_seed(derive_seed(tcfg.seed, 0x7FFFFFFF))
    model = TabICAModel.create(init_gen, cfg, device)
    params = model.params
    state_path = ckpt_path + ".train_state.npz"
    if init_from and not (resume and os.path.exists(state_path)):
        from .warmstart import load_warmstart

        params = load_warmstart(init_from, cfg, device).params
        print(f"[pretrain] warm-started from {init_from}")
    opt_state = make_optimizer(tcfg).init(params)
    step = 0

    if resume and os.path.exists(state_path):
        saved = pytree_io.load_pytree(state_path + ".meta.npz")
        step = int(saved["step"])
        params = pytree_io.restore_like(params, ckpt_path)
        opt_state = pytree_io.restore_like(opt_state, state_path)
        print(f"[pretrain] resumed at step {step}")

    best_path = ckpt_path.replace(".npz", "_best.npz")
    best_meta = best_path + ".meta.npz"
    best_val = float("inf")
    if os.path.exists(best_meta):
        best_val = float(pytree_io.load_pytree(best_meta)["val"])
        print(f"[pretrain] best-so-far val NLL {best_val:.4f}")

    log_f = open(log_path, "a") if log_path else None
    val_seed = 10_000
    t_start = time.time()
    t_last = t_start
    loss_acc, n_acc = None, 0
    profiler, profile_stop_at = None, None
    if profile_dir is None:
        profile_dir = os.path.join(tempfile.gettempdir(), "npe_pfn_tpu_torch_pretrain_trace")

    while step < tcfg.max_steps:
        if profile_steps and profiler is None and step >= 1:
            profiler = _start_profiler(device)
            profile_stop_at = step + profile_steps
            print(f"[pretrain] profiling {profile_steps} steps -> {profile_dir}")
        gen = torch.Generator(device).manual_seed(derive_seed(tcfg.seed, step))
        if tcfg.feat_curriculum_steps > 0:
            frac = min(1.0, step / tcfg.feat_curriculum_steps)
            max_feat = round(tcfg.feat_curriculum_init
                             + frac * (pcfg.max_active_features - tcfg.feat_curriculum_init))
        else:
            max_feat = None
        params, opt_state, loss, gnorm = train_step(
            cfg, tcfg, pcfg, params, opt_state, model.borders, gen, max_feat)
        step += 1
        loss_acc = loss if loss_acc is None else loss_acc + loss
        n_acc += 1
        if profile_stop_at is not None and step >= profile_stop_at:
            profile_stop_at = None
            _stop_profiler(profiler, device, profile_dir)
            print(f"[pretrain] profile written to {profile_dir}")
        if step == 1 or (step < tcfg.log_every and step % 10 == 0):
            print(f"[pretrain] step {step} loss {float(loss_acc) / n_acc:.4f} "
                  f"({time.time() - t_start:.1f}s elapsed)", flush=True)

        if step % tcfg.log_every == 0:
            now = time.time()
            rec = {
                "step": step,
                "loss": float(loss_acc) / n_acc,
                "gnorm": float(gnorm),
                "steps_per_s": tcfg.log_every / (now - t_last),
                "elapsed_s": now - t_start,
            }
            _log(log_f, rec)
            loss_acc, n_acc = None, 0
            t_last = now

        if step % tcfg.val_every == 0:
            val = float(eval_step(cfg, params, pcfg, model.borders, val_seed))
            _log(log_f, {"step": step, "val_nll": val})
            if val < best_val:
                best_val = val
                ckpt_mod.save(best_path, TabICAModel(cfg=cfg, params=params, borders=model.borders))
                pytree_io.save_pytree(best_meta, {"step": np.array(step), "val": np.array(val)})
                print(f"[pretrain] new best val NLL {val:.4f} -> {best_path}", flush=True)

        if step % tcfg.ckpt_every == 0 or step == tcfg.max_steps:
            _save_all(ckpt_path, cfg, params, opt_state, step, model.borders)

        if time_limit_s and (time.time() - t_start) > time_limit_s:
            print(f"[pretrain] time limit reached at step {step}")
            break

    if profile_stop_at is not None:
        _stop_profiler(profiler, device, profile_dir)
    _save_all(ckpt_path, cfg, params, opt_state, step, model.borders)
    if log_f:
        log_f.close()
    return TabICAModel(cfg=cfg, params=params, borders=model.borders)


def _log(log_f, rec):
    print(f"[pretrain] {json.dumps(rec)}", flush=True)
    if log_f:
        log_f.write(json.dumps(rec) + "\n")
        log_f.flush()


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device, profile_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=60))


def _save_all(ckpt_path, cfg, params, opt_state, step, borders):
    ckpt_mod.save(ckpt_path, TabICAModel(cfg=cfg, params=params, borders=borders))
    pytree_io.save_pytree(ckpt_path + ".train_state.npz", opt_state)
    pytree_io.save_pytree(ckpt_path + ".train_state.npz.meta.npz", {"step": np.array(step)})
    print(f"[pretrain] checkpoint @ step {step} -> {ckpt_path}", flush=True)
