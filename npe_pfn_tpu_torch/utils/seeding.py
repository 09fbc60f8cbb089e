"""Integer seeds for ``torch.Generator`` streams."""

import numpy as np


def derive_seed(*ints: int) -> int:
    """A 63-bit seed from integers (the JAX package's ``fold_in`` chain)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(1, dtype=np.uint64)
    return int(state[0]) & ((1 << 63) - 1)
