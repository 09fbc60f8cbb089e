"""Write scripts/torch_ratio_context.npz: a fitted classifier context of the
ratio density and what the CPU plain path reads on it.

    python3 scripts/export_ratio_context.py      # from the repo root; seconds

The context is the ratio protocol's (scripts/torch_sequential_protocols.py,
seed 0, 10-D gaussian_linear) fitted by ``DensityRatioEstimator.fit`` at 256
rows, with 4096 analytic-posterior draws standing in for the estimator's.
θ is stored in float16 (about 11 KB in all) and read back as float32, so that
both sides score the same numbers: 192 posterior draws and 64 uniform draws
from the classifier's box widened by a fifth (some fall outside it and take
the floor). ``lp_cpu`` is ``ratio_log_probs`` of the shipped checkpoint (bf16,
dense row attention) on the CPU. The script also prints how far the same
reading moves with the scores in float32 and with the whole model in float32,
the rounding noise that chip_smoke.py phase 20's bounds are set against.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_sequential_protocols as proto  # noqa: E402
from npe_pfn_tpu_torch import DensityRatioEstimator, load_default  # noqa: E402
from npe_pfn_tpu_torch.tasks import get_task  # noqa: E402

CONTEXT, POSTERIOR_DRAWS, EVAL_POSTERIOR, EVAL_BOX = 256, 4096, 192, 64


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = torch.device("cpu")
    task = get_task("gaussian_linear", device=dev)
    x_o = task.simulate(proto._gen(dev, 0, proto.OBS), 1)[1][0]
    post = task.posterior_sampler(proto._gen(dev, 0, proto.GT), x_o, POSTERIOR_DRAWS)
    model = load_default(dev)
    est = DensityRatioEstimator(model, context_size=CONTEXT)
    est.fit(proto._gen(dev, 0, proto.RUN), post, x_o, ctx_fingerprint=0)
    f16 = lambda a: a.to(torch.float16).numpy()  # noqa: E731
    gen = proto._gen(dev, 0, proto.METRIC)
    span = est._high - est._low
    box = est._low - 0.1 * span + 1.2 * span * torch.rand((EVAL_BOX, span.shape[0]), generator=gen)
    theta_eval = torch.cat([task.posterior_sampler(gen, x_o, EVAL_POSTERIOR), box])
    data = {"ctx_theta": f16(est._ctx_theta), "ctx_labels": est._ctx_labels.to(torch.uint8).numpy(),
            "low": est._low.numpy(), "high": est._high.numpy(), "theta_eval": f16(theta_eval)}
    np.savez_compressed(proto.RATIO_CONTEXT, **data, lp_cpu=np.zeros(len(theta_eval), np.float32))
    reads = {}
    for name, over in (("shipped", {}), ("f32 scores", dict(scores_dtype="float32")),
                       ("f32 model", dict(dtype="float32", scores_dtype="float32"))):
        m = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg, **over))
        ratio, th, _ = proto.ratio_context(m)
        reads[name] = ratio.ratio_log_probs(th)
    np.savez_compressed(proto.RATIO_CONTEXT, **data, lp_cpu=reads["shipped"].numpy())
    inside = ((theta_eval >= est._low) & (theta_eval <= est._high)).all(-1)
    print(f"{proto.RATIO_CONTEXT}: {os.path.getsize(proto.RATIO_CONTEXT)} bytes; "
          f"{int(inside.sum())} of {len(theta_eval)} θ inside the box")
    for name in ("f32 scores", "f32 model"):
        d = (reads[name] - reads["shipped"]).abs()
        print(f"|{name} - shipped| median {d.median().item():.4f}, p99 "
              f"{d.quantile(0.99).item():.4f}, max {d.max().item():.4f} nats")


if __name__ == "__main__":
    main()
