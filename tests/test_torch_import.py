"""The port stands alone: importing npe_pfn_tpu_torch (and chip_smoke.py)
loads nothing of JAX or of the JAX package, not even to build the twelve
tasks, and chip_smoke.py fails without a card instead of printing a result.
The evaluation does not load the trainer, and chip_smoke.py's c2st bands
follow their calibration rule."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import REPO

torch.set_num_threads(2)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "npe_pfn_tpu", "bench", "__graft_entry__")


def _run(code, cwd=REPO, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_import_loads_no_jax():
    code = (
        "import sys, npe_pfn_tpu_torch, npe_pfn_tpu_torch.estimator\n"
        "import npe_pfn_tpu_torch.ops.flash_attention, npe_pfn_tpu_torch.ops._build\n"
        "import npe_pfn_tpu_torch.pretrain.train, npe_pfn_tpu_torch.pretrain.__main__\n"
        "import npe_pfn_tpu_torch.pretrain.warmstart, npe_pfn_tpu_torch.utils.pytree_io\n"
        "import npe_pfn_tpu_torch.preprocessing, npe_pfn_tpu_torch.rejection\n"
        "import npe_pfn_tpu_torch.serving, npe_pfn_tpu_torch.utils.profiling\n"
        "import npe_pfn_tpu_torch.embeddings, npe_pfn_tpu_torch.distributions\n"
        "import npe_pfn_tpu_torch.eval.metrics, npe_pfn_tpu_torch.eval.harness\n"
        "import npe_pfn_tpu_torch.utils.seeding, npe_pfn_tpu_torch.utils.roofline\n"
        "import npe_pfn_tpu_torch.support, npe_pfn_tpu_torch.restricted_prior\n"
        "import npe_pfn_tpu_torch.tsnpe, npe_pfn_tpu_torch.unconditional\n"
        "import npe_pfn_tpu_torch.eval.calibration, npe_pfn_tpu_torch.__main__\n"
        "import npe_pfn_tpu_torch.parallel, npe_pfn_tpu_torch.parallel.context_sharded\n"
        "from npe_pfn_tpu_torch.tasks import get_task, list_tasks\n"
        "tasks = [get_task(n, device='cpu') for n in list_tasks()]\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    root = os.path.join(REPO, "npe_pfn_tpu_torch")
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "scripts", "torch_sequential_protocols.py")


def test_sources_import_nothing_of_jax():
    for path in _port_sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    """Without CUDA (and, alone, without the package) the script exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_drives_the_evaluation_phases():
    """chip_smoke.py runs the metrics (phase 17) and evaluate_task (phase 18)
    through the port's eval package, and reads its c2st bands from the
    committed calibration file."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert {"phase_metrics", "phase_evaluate"} <= names
    called = {n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"phase_metrics", "phase_evaluate"} <= called
    mods = set(_imports(os.path.join(REPO, "chip_smoke.py")))
    assert {"npe_pfn_tpu_torch.eval", "npe_pfn_tpu_torch.eval.harness"} & mods
    assert os.path.exists(os.path.join(REPO, "scripts", "torch_eval_bands.json"))


def test_evaluation_loads_no_trainer():
    """eval.harness takes its seeds from utils.seeding, not from the trainer."""
    code = ("import sys, npe_pfn_tpu_torch.eval.harness\n"
            "bad = sorted(m for m in sys.modules if m.startswith('npe_pfn_tpu_torch.pretrain'))\n"
            "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eval_bands_follow_their_rule():
    """Every band in the committed calibration file comes from JAX readings on
    at least ten seeds, all committed beside it: mean ± max(0.05, 3 × std)."""
    with open(os.path.join(REPO, "scripts", "torch_eval_bands.json")) as f:
        calib = json.load(f)
    seeds = calib["protocol"]["seeds"]
    assert len(seeds) >= 10
    assert set(calib["tasks"]) == {
        "two_moons", "gaussian_linear", "slcp", "lotka_volterra", "sir", "pendulum",
        "wind_tunnel", "gaussian_bump_image", "gaussian_mixture", "bernoulli_glm",
        "gaussian_linear_uniform", "high_dim_gaussian"}
    for name, entry in calib["tasks"].items():
        reads = [entry["jax"][f"num_cal=1000/seed={s}"]["c2st"] for s in seeds]
        half = max(0.05, 3 * float(np.std(reads)))
        np.testing.assert_allclose(entry["band"], [np.mean(reads) - half, np.mean(reads) + half],
                                   rtol=1e-12, err_msg=name)


def test_sequential_bands_follow_their_rule():
    """Every band of chip_smoke.py's sequential phases comes from JAX readings
    on seeds 0-9, all committed beside it: mean ± max(0.05, 3 × std)."""
    with open(os.path.join(REPO, "scripts", "torch_sequential_bands.json")) as f:
        calib = json.load(f)
    want = {"refine.c2st", "refine.ess", "refine.eps", "ratio.pearson_r", "ece.ece",
            "uncond.max_abs_mean", "uncond.std_min", "uncond.std_max",
            "uncond.median_abs_lp_diff"}
    assert set(calib["bands"]) == want
    for name, entry in calib["bands"].items():
        what, metric = name.split(".")
        reads = [calib["readings"][what]["jax"][f"seed{s}"][metric] for s in range(10)]
        half = max(0.05, 3 * float(np.std(reads)))
        np.testing.assert_allclose(entry["band"], [np.mean(reads) - half, np.mean(reads) + half],
                                   rtol=1e-12, err_msg=name)


def test_chip_smoke_sequential_protocols_load_no_jax():
    """chip_smoke.py's phases 20-21 take their protocols and bands from
    scripts/torch_sequential_protocols.py; loading them, and running one
    protocol on a small model on the CPU, loads nothing of JAX."""
    code = (
        "import sys, torch, chip_smoke as cs\n"
        "from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel\n"
        "seqcal, bands = cs._seqcal(), cs._seq_bands()\n"
        "assert set(bands) == {f'{w}.{m}' for w, ms in seqcal.BANDED.items() for m in ms}\n"
        "cfg = TabICAConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, "
        "num_bars=32, dtype='float32')\n"
        "model = TabICAModel.create(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "reads = seqcal.torch_ece(model, 0)\n"
        "assert 0.0 <= reads['ece'] <= 1.0, reads\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
