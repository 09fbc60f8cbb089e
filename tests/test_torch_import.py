"""The port stands alone: importing npe_pfn_tpu_torch (and chip_smoke.py)
loads nothing of JAX or of the JAX package, and chip_smoke.py fails without a
card instead of printing a result."""

import ast
import os
import subprocess
import sys

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
