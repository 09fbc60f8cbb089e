#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases on the card, alone or for several trees in turns.

    python3 scripts/chip_phases.py --phases seq          # from the repo root
    python3 scripts/chip_phases.py --phases parallel
    python3 scripts/chip_phases.py --phases main \
        --trees parent=_chip_scratch/parent,change=.,change=.,parent=_chip_scratch/parent
    python3 scripts/chip_phases.py --phases eval \
        --trees parent=_chip_scratch/parent,change=.,change=.,parent=_chip_scratch/parent

``seq`` runs phases 19-22 (sequential inference and the kernel at its
shapes) of this checkout after the build, with every gate of chip_smoke.py.
``eval`` runs phases 17-18 (metrics and ``evaluate_task`` on the twelve
tasks). ``parallel`` runs phase 5 (whose first request phase 26 repeats)
and phase 26 (npe_pfn_tpu_torch.parallel in one NCCL group of one rank).
``main`` runs phase 5, times three more of its requests, and runs phase 9
(the pretrain_v7 steps): the single-device request and step times. With ``--trees`` each ``label=dir`` (a checkout of the repo, e.g. a
``git archive`` of the parent commit) runs in its own process, one after the
other in the order given, and prints one ``PAIR <label>`` line of phase
times: compare two commits inside one call, in turns (parent, change,
change, parent), because times differ between cards and hosts.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def run_here(phases):
    """The phases of the checkout in the working directory."""
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import npe_pfn_tpu_torch
    from npe_pfn_tpu_torch import load_default

    if not os.path.abspath(npe_pfn_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"npe_pfn_tpu_torch is not {root}'s: {npe_pfn_tpu_torch.__file__}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases.py runs on a CUDA card")
    smi = cs.phase_device()
    cs.phase_build()
    times = {}
    if phases == "main":
        est, _, x, _, _ = cs.phase_main_path()
        for i in range(3):
            gen = torch.Generator("cuda").manual_seed(100 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.sample(cs.SAMPLES, x[i + 1], generator=gen)
            torch.cuda.synchronize()
            times[f"request {i}"] = time.perf_counter() - t0
        times["steps_per_s"] = cs.phase_train()["steps_per_s"]
        return times
    if phases == "parallel":
        t0 = time.perf_counter()
        est, _, _, request, _ = cs.phase_main_path()
        times["phase 5"] = time.perf_counter() - t0
        out = cs.phase_parallel(est, request, smi)
        times["phase 26"] = out["phase_seconds"]
        times.update({f"parallel {k}": v for k, v in out["seconds"].items()})
        return times
    model = load_default(torch.device("cuda"))
    if phases == "eval":
        t0 = time.perf_counter()
        cs.phase_metrics(smi)
        times["phase 17"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, sampler_s = cs.phase_evaluate(model, smi)
        times["phase 18"] = time.perf_counter() - t0
        times.update({f"sampler {k}": v for k, v in sampler_s.items()})
        times.update({f"task {k}": e["seconds"] for k, e in out.items()})
    else:
        t0 = time.perf_counter()
        with cs.record_shapes() as shapes:
            tsnpe = cs.phase_tsnpe(model, smi)
            cs.phase_refine_ratio(model, smi)
            cs.phase_heads(model, tsnpe, smi)
        times["phases 19-21"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_seq_kernel(shapes)
        times["phase 22"] = time.perf_counter() - t0
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", choices=("seq", "eval", "parallel", "main"), required=True)
    ap.add_argument("--trees", default=None, help="label=dir,... run in turns")
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.trees is None:
        times = run_here(args.phases)
        print(f"PAIR {args.label}: " + json.dumps({k: round(v, 3) for k, v in times.items()}),
              flush=True)
        return
    for item in args.trees.split(","):
        label, tree = item.split("=", 1)
        # The phases of the tree's own chip_smoke.py, run by this script's copy.
        cmd = [sys.executable, os.path.abspath(__file__), "--phases", args.phases, "--label",
               label]
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run(cmd, cwd=os.path.abspath(tree), env=env, capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PAIR")]
        print(lines[-1] if lines else f"PAIR {label}: failed rc={proc.returncode}\n"
              + proc.stderr[-2000:], flush=True)


if __name__ == "__main__":
    main()
