"""Command-line entry point: ``python -m npe_pfn_tpu_torch <command>``.

Counterpart of ``npe_pfn_tpu/__main__.py``. Commands:

- ``info``   — version, torch and CUDA, the card, the checkpoint;
- ``tasks``  — the task registry and the ground truth each task has;
- ``sample`` — training-free posterior sampling on a task: simulate, bind
  the context, draw posterior samples at an observation, save ``.npy``;
- ``tsnpe``  — sequential (truncated) inference within a simulation budget.

``sample`` and ``tsnpe`` run on ``--device`` (default CUDA; without a card
they raise). On the CPU the checkpoint's bf16 compute dtype is coerced to
float32, as the JAX package does off the TPU; weights are stored in float32,
so only the matmul rounding changes.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_model(device):
    from .models import checkpoint

    model = checkpoint.load_default(device)
    if model.device.type == "cpu" and model.cfg.dtype == "bfloat16":
        model = checkpoint.load_default(device, dtype="float32", scores_dtype="float32")
        print("[cli] CPU: compute dtype coerced bf16 -> f32", file=sys.stderr)
    return model


def cmd_info(args):
    import torch

    from . import __version__
    from .models import checkpoint

    path = checkpoint.default_checkpoint_path()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rec = {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "checkpoint": path,
    }
    try:
        with open(path + ".json") as f:
            rec["model_config"] = json.load(f)
    except OSError:
        rec["model_config"] = None
    print(json.dumps(rec, indent=2))


def cmd_tasks(args):
    from .tasks import get_task, list_tasks

    rows = []
    for name in list_tasks():
        t = get_task(name, device="cpu")
        gt = [label for label, fn in (("posterior-sampler", t.posterior_sampler),
                                      ("log-prob", t.posterior_log_prob)) if fn is not None]
        rows.append((name, t.dim_theta, t.dim_x, "+".join(gt) or "-"))
    w = max(len(r[0]) for r in rows)
    print(f"{'task':<{w}}  dim_theta  dim_x  ground_truth")
    for name, dt, dx, gt in rows:
        print(f"{name:<{w}}  {dt:>9}  {dx:>5}  {gt}")


def _common_sampling_args(p):
    p.add_argument("--task", required=True, help="see the `tasks` command")
    p.add_argument("--num-sims", type=int, default=1024,
                   help="simulation budget (context size before filtering)")
    p.add_argument("--num-samples", type=int, default=1024,
                   help="posterior draws at the observation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x-o", type=float, nargs="*", default=None,
                   help="observation; default: simulate one from the prior")
    p.add_argument("--out", default=None, help="save samples to this .npy")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a card)")


def _setup(args):
    """The task on the device, the model and the run's generator."""
    import torch

    from ._device import resolve_device
    from .tasks import get_task

    device = resolve_device(args.device)
    task = get_task(args.task, device=device)
    return task, _load_model(device), torch.Generator(device).manual_seed(args.seed)


def _resolve_observation(task, args, generator):
    import torch

    if args.x_o is not None:
        x_o = torch.tensor(args.x_o, dtype=torch.float32, device=generator.device)
        if x_o.shape != (task.dim_x,):
            raise SystemExit(f"--x-o needs {task.dim_x} values for {task.name}, got "
                             f"{x_o.shape[0]}")
        return x_o, None
    theta_true, x = task.simulate(generator, 1)
    return x[0], theta_true[0]


def _report(samples, theta_true, out):
    import numpy as np

    s = samples.cpu().numpy()
    print(f"posterior samples: {s.shape}")
    for d in range(s.shape[1]):
        line = f"  theta[{d}]: mean {s[:, d].mean():+.4f}  std {s[:, d].std():.4f}"
        if theta_true is not None:
            line += f"  (true {float(theta_true[d]):+.4f})"
        print(line)
    if out:
        np.save(out, s)
        print(f"saved -> {out}")


def cmd_sample(args):
    from .estimator import NPEPFN

    task, model, gen = _setup(args)
    theta, x = task.simulate(gen, args.num_sims)
    x_o, theta_true = _resolve_observation(task, args, gen)
    est = NPEPFN(prior=task.prior, model=model)
    est.append_simulations(theta, x)
    samples = est.sample(args.num_samples, x_o, generator=gen)
    _report(samples, theta_true, args.out)


def cmd_tsnpe(args):
    from .tsnpe import run_tsnpe

    task, model, gen = _setup(args)
    x_o, theta_true = _resolve_observation(task, args, gen)
    est = run_tsnpe(task.simulator, task.prior, x_o, num_rounds=args.num_rounds,
                    num_simulations=args.num_sims, generator=gen, model=model)
    samples = est.sample(args.num_samples, x_o, generator=gen)
    _report(samples, theta_true, args.out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m npe_pfn_tpu_torch",
        description="training-free simulation-based inference on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", help="version / checkpoint / devices").set_defaults(fn=cmd_info)
    sub.add_parser("tasks", help="list benchmark tasks").set_defaults(fn=cmd_tasks)
    p = sub.add_parser("sample", help="training-free posterior sampling")
    _common_sampling_args(p)
    p.set_defaults(fn=cmd_sample)
    p = sub.add_parser("tsnpe", help="sequential (truncated) inference")
    _common_sampling_args(p)
    p.add_argument("--num-rounds", type=int, default=3)
    p.set_defaults(fn=cmd_tsnpe)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
