"""Max errors of the PyTorch port against the JAX package, module by module (CPU).

Runs the comparisons of tests/test_torch_*.py once on the CPU and prints the
largest error of each beside the tolerance the test enforces, as the parity
table of PERF.md. Everything is f32 except the bf16 line. Inputs are numpy
from fixed seeds; JAX weights are carried into the port.

    JAX_PLATFORMS=cpu python3 scripts/torch_parity_report.py
"""

import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")

from npe_pfn_tpu import estimator as je  # noqa: E402
from npe_pfn_tpu.models import TabICAConfig, TabICAModel  # noqa: E402
from npe_pfn_tpu.models import bar_distribution as jbar  # noqa: E402
from npe_pfn_tpu.models import checkpoint as jck  # noqa: E402
from npe_pfn_tpu.models import regressor as jr  # noqa: E402
from npe_pfn_tpu.models import transformer as jt  # noqa: E402
from npe_pfn_tpu.ops import flash_attention as jfa  # noqa: E402
from npe_pfn_tpu_torch import estimator as te  # noqa: E402
from npe_pfn_tpu_torch.models import bar_distribution as tbar  # noqa: E402
from npe_pfn_tpu_torch.models import checkpoint as tck  # noqa: E402
from npe_pfn_tpu_torch.models import regressor as tr  # noqa: E402
from npe_pfn_tpu_torch.models import transformer as tt  # noqa: E402
from npe_pfn_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from torch_parity import SHIPPED, port_model, t  # noqa: E402

torch.set_num_threads(4)
rows = []


def report(module, what, out, ref, tol):
    err = float(np.max(np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))))
    rows.append((module, what, err, tol))


def main():
    rng = np.random.default_rng(0)
    borders = np.asarray(jbar.make_borders(1024, 6.0))
    report("bar_distribution", "make_borders (1024 bars)", tbar.make_borders(1024).numpy(),
           borders, "atol 1e-6")
    logits = (2 * rng.standard_normal((64, 1024))).astype(np.float32)
    y = rng.uniform(-8, 8, 64).astype(np.float32)
    for fn in ("log_prob", "cdf"):
        report("bar_distribution", fn, getattr(tbar, fn)(t(borders), t(logits), t(y)).numpy(),
               getattr(jbar, fn)(borders, logits, y), "rtol/atol 1e-5")

    q = rng.standard_normal((3, 100, 2, 128)).astype(np.float32)
    k = rng.standard_normal((3, 150, 2, 128)).astype(np.float32)
    v = rng.standard_normal((3, 150, 2, 128)).astype(np.float32)
    m = np.arange(150)[None] < np.array([[150], [90], [0]])
    report("ops.flash_attention", "plain version vs Pallas interpret (hd 128, per-batch mask)",
           tfa.flash_row_attention(t(q), t(k), t(v), t(m)).numpy(),
           jfa.flash_row_attention(q, k, v, m, block_q=32, block_k=32, interpret=True),
           "rtol 2e-4, atol 2e-5")

    cfg = TabICAConfig(d_model=64, num_heads=2, num_layers=2, max_features=12, num_bars=16,
                       dtype="float32")
    jm = TabICAModel.create(jax.random.PRNGKey(64), cfg)
    tm = port_model(jm)
    x_ctx = rng.standard_normal((40, 12)).astype(np.float32)
    y_ctx = rng.standard_normal(40).astype(np.float32)
    x_qry = rng.standard_normal((16, 12)).astype(np.float32)
    cm = np.arange(40) < 33
    ref = jt.forward(cfg, jm.params, x_ctx, y_ctx, x_qry, ctx_mask=cm)
    for flash in ("auto", "on"):
        out = tt.forward(dataclasses.replace(tm.cfg, flash=flash), tm.params, t(x_ctx),
                         t(y_ctx), t(x_qry), ctx_mask=t(cm))
        report("models.transformer", f"forward, d64 (flash {flash})", out.numpy(), ref,
               "rtol 1e-4, atol 2e-5")
    jf = jr.fit_encode(jm, x_ctx, y_ctx, ctx_mask=cm)
    tf = tr.fit_encode(tm, t(x_ctx), t(y_ctx), ctx_mask=t(cm))
    lg = jr.predict_logits(jm, jf, x_qry)
    report("models.regressor", "fit_encode + predict_logits",
           tr.predict_logits(tm, tf, t(x_qry)).numpy(), lg, "rtol 1e-4, atol 2e-5")

    jcfg = dataclasses.replace(cfg, dtype="bfloat16", scores_dtype="bfloat16")
    tcfg = dataclasses.replace(tm.cfg, dtype="bfloat16", scores_dtype="bfloat16")
    ref = np.asarray(jt.forward(jcfg, jm.params, x_ctx, y_ctx, x_qry))
    out = tt.forward(tcfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry)).numpy()
    report("models.transformer", "forward, d64, bf16", out, ref,
           f"atol 1e-2 x max|logit| = {1e-2 * np.abs(ref).max():.2e}")

    sj = jck.load(SHIPPED)
    sj = sj.replace(cfg=dataclasses.replace(sj.cfg, dtype="float32", scores_dtype="float32"))
    st = tck.load(SHIPPED, "cpu", dtype="float32", scores_dtype="float32")
    xc = rng.standard_normal((128, 24)).astype(np.float32)
    yc = rng.standard_normal(128).astype(np.float32)
    xq = rng.standard_normal((32, 24)).astype(np.float32)
    fm = np.arange(24) < 17
    ref = jt.decode_queries(sj.cfg, sj.params, jt.encode_context(sj.cfg, sj.params, xc, yc, fm),
                            xq, fm)
    out = tt.decode_queries(st.cfg, st.params, tt.encode_context(st.cfg, st.params, t(xc), t(yc),
                                                                   t(fm)), t(xq), t(fm))
    report("models.transformer", "tabica_v6_best f32, 128 rows, encode + decode", out.numpy(),
           ref, "rtol 1e-4, atol 1e-4 x max|logit|")

    small = TabICAModel.create(jax.random.PRNGKey(0), dataclasses.replace(
        cfg, d_model=32, max_features=32, num_bars=32))
    smt = port_model(small)
    theta = rng.standard_normal((128, 8)).astype(np.float32)
    x = (theta @ rng.standard_normal((8, 10)) / 3).astype(np.float32)
    xq = rng.standard_normal((64, 10)).astype(np.float32)
    th = rng.standard_normal((64, 8)).astype(np.float32)
    cm = np.arange(128) < 120
    ref = je.autoregressive_log_prob(small, theta, x, cm, xq, th, qry_chunk=32)
    out = te.autoregressive_log_prob(smt, t(theta), t(x), t(cm), t(xq), t(th), qry_chunk=32)
    report("estimator", "autoregressive_log_prob, dx 10, dθ 8 (widths 16/24)", out.numpy(), ref,
           "rtol/atol 1e-4")

    print("| module | comparison | dtype | device | max abs error | tolerance |")
    print("|---|---|---|---|---|---|")
    for module, what, err, tol in rows:
        dtype = "bf16" if "bf16" in what else "f32"
        print(f"| {module} | {what} | {dtype} | CPU | {err:.3e} | {tol} |")


if __name__ == "__main__":
    main()
