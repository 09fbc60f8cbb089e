"""The port's command line, ``python -m npe_pfn_tpu_torch``, against the JAX
package's (``python -m npe_pfn_tpu``), on the CPU.

``tasks`` prints the JAX package's table, row for row; ``info`` names the
version, torch, the cards (none here) and the checkpoint; observation
handling follows JAX's (a wrong length exits). ``sample`` and ``tsnpe`` run
end to end with ``--device cpu`` on a small random model (the checkpoint
loader is replaced; the shipped one is driven on the card by chip_smoke.py)
and save their draws; without ``--device`` they want CUDA, and raise here.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from npe_pfn_tpu import __main__ as jcli
from npe_pfn_tpu_torch import __main__ as cli
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
from npe_pfn_tpu_torch.tasks import get_task

torch.set_num_threads(2)


def test_tasks_command_prints_the_jax_table(capsys):
    jcli.main(["tasks"])
    want = capsys.readouterr().out
    cli.main(["tasks"])
    assert capsys.readouterr().out == want


def test_info_command(capsys):
    cli.main(["info"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["version"] == "0.1.0" and rec["torch"] == torch.__version__
    assert rec["devices"] == [] and rec["checkpoint"].endswith(".npz")
    assert rec["model_config"]["d_model"] == 256


def test_observation_validation():
    task = get_task("two_moons", device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(SystemExit):
        cli._resolve_observation(task, argparse.Namespace(x_o=[1.0, 2.0, 3.0]), gen)
    x_o, theta_true = cli._resolve_observation(task, argparse.Namespace(x_o=[0.1, -0.2]), gen)
    assert x_o.shape == (2,) and theta_true is None
    x_o, theta_true = cli._resolve_observation(task, argparse.Namespace(x_o=None), gen)
    assert x_o.shape == (2,) and theta_true.shape == (2,)


@pytest.fixture
def tiny_model(monkeypatch):
    cfg = TabICAConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                       dtype="float32")
    model = TabICAModel.create(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    monkeypatch.setattr(cli, "_load_model", lambda device: model)


@pytest.mark.parametrize("cmd", [["sample"], ["tsnpe", "--num-rounds", "2"]])
def test_sampling_commands_run_on_the_cpu(tiny_model, tmp_path, capsys, cmd):
    out = tmp_path / "s.npy"
    cli.main(cmd + ["--task", "two_moons", "--num-sims", "200", "--num-samples", "64",
                    "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "posterior samples: (64, 2)" in printed and "(true " in printed
    s = np.load(out)
    assert s.shape == (64, 2) and np.isfinite(s).all()


def test_sampling_commands_want_a_card_by_default(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["sample", "--task", "two_moons"])


def test_cpu_model_is_coerced_to_f32():
    """As the JAX package's CLI does off the TPU."""
    model = cli._load_model("cpu")
    assert (model.cfg.dtype, model.cfg.scores_dtype) == ("float32", "float32")
