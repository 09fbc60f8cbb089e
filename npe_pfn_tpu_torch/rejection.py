"""Generic rejection-sampling loop.

Counterpart of ``npe_pfn_tpu/rejection.py``: loop proposal → accept mask →
accumulate until ``num_samples``, with a ``max_iters`` escape hatch that
fills the remainder with the last batch's unused rows, and the acceptance
rate. Every round draws the same fixed-size batch. Accumulation stays on the
device: accepted rows are stable-sorted to the front and the whole sorted
batch is written at the fill offset; the accepted count is the one value read
back per round.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .utils.profiling import Progress

ProposalFn = Callable[[torch.Generator, int], Tuple[torch.Tensor, torch.Tensor]]
AcceptFn = Callable[[torch.Tensor], torch.Tensor]


def _partition_accepted(samples, aux, mask):
    """Accepted rows first, draw order kept within both groups; plus the
    accepted count (on the device)."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    return samples[order], aux[order], mask.sum()


def accept_reject_sample(
    generator: torch.Generator,
    proposal_fn: ProposalFn,
    accept_reject_fn: AcceptFn,
    num_samples: int,
    batch_size: Optional[int] = None,
    max_iters: int = 10,
    show_progress: bool = False,
):
    """Draw ``num_samples`` accepted samples.

    ``proposal_fn(generator, n) -> (samples [n, d], aux [n, ...])``;
    ``accept_reject_fn(samples) -> bool [n]``. Returns (samples
    [num_samples, d], aux trimmed alike, acceptance rate).
    """
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")
    batch_size = batch_size or num_samples
    progress = Progress(num_samples, "accept_reject", enabled=show_progress)
    acc_s = acc_aux = last = None
    drawn = accepted = filled = 0
    for _ in range(max_iters):
        samples, aux = proposal_fn(generator, batch_size)
        sorted_s, sorted_aux, n_acc = _partition_accepted(samples, aux,
                                                          accept_reject_fn(samples))
        n_acc = int(n_acc)  # the round's one read from the device
        last = (sorted_s, sorted_aux, n_acc)
        if acc_s is None:  # slack for a whole batch written at offset num_samples - 1
            acc_s = samples.new_zeros((num_samples + batch_size,) + samples.shape[1:])
            acc_aux = aux.new_zeros((num_samples + batch_size,) + aux.shape[1:])
        # The accepted prefix lands after the rows accepted so far; the
        # rejected tail is overwritten by the next write or the escape hatch.
        acc_s[filled:filled + batch_size] = sorted_s
        acc_aux[filled:filled + batch_size] = sorted_aux
        drawn += batch_size
        accepted += n_acc
        take = min(n_acc, num_samples - filled)
        filled += take
        progress.update(take)
        if filled >= num_samples:
            break
    if filled < num_samples:
        # Escape hatch: the last batch's unused rows. Every accepted row of
        # it was consumed, so rotating the sorted batch past n_acc (rejected
        # rows first) duplicates no returned row unless the deficit exceeds
        # the rejected count.
        deficit = num_samples - filled
        reps = -(-deficit // batch_size)
        last_s, last_aux, last_na = last
        roll = (torch.arange(batch_size, device=last_s.device) + last_na) % batch_size
        acc_s[filled:num_samples] = last_s[roll].repeat((reps,) + (1,) * (last_s.dim() - 1))[
            :deficit]
        acc_aux[filled:num_samples] = last_aux[roll].repeat(
            (reps,) + (1,) * (last_aux.dim() - 1))[:deficit]
    return acc_s[:num_samples], acc_aux[:num_samples], accepted / max(drawn, 1)
