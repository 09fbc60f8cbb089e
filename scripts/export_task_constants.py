#!/usr/bin/env python3
"""Write the fixed task constants that the JAX package draws from PRNG keys
to ``npe_pfn_tpu_torch/tasks/constants.npz``, for the PyTorch port.

Two tasks draw fixed parameters once from a JAX key: bernoulli_glm's design
matrix V [100, 10] (``_glm_design``, ``PRNGKey(1234)``) and high_dim_gaussian's
eight parameter arrays (``_hdg_params``, ``PRNGKey(0)``). torch cannot
reproduce threefry, and other draws would make other tasks, so the port loads
these arrays, taken at the task constructors' default sizes (dim 10; theta_dim
3, obs_dim 3). Run from the repository root (needs JAX, on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/export_task_constants.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "npe_pfn_tpu_torch", "tasks", "constants.npz")
HDG_NAMES = ("prior_loc", "prior_cov", "a_mat", "b_vec", "lik_cov", "c_mat", "d_vec",
             "noise_cov")


def constants():
    """{name: float32 array} of the JAX package's fixed task draws."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from npe_pfn_tpu.tasks import registry

    out = {"glm_design": np.asarray(registry._glm_design(10))}
    for name, arr in zip(HDG_NAMES, registry._hdg_params(3, 3)):
        out["hdg_" + name] = np.asarray(arr)
    return out


def main():
    arrays = constants()
    np.savez(OUT, **arrays)
    for name, arr in arrays.items():
        print(f"{name}: {arr.shape} {arr.dtype}")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
