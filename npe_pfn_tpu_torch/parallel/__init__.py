"""Multi-rank TabICA on ``torch.distributed``: the counterpart of
``npe_pfn_tpu.parallel`` (data parallelism, context sharding, tensor,
pipeline and expert parallelism) and of its multi-rank dry run."""

from .dryrun import dryrun_multichip
from .expert_parallel import ep_place, ep_pspecs
from .mesh import (
    get_mesh,
    init_distributed,
    make_sharded_train_step,
    shard_batch,
    sharded_autoregressive_sample,
)
from .pipeline import pp_decode, pp_fit_encode
from .tensor_parallel import Spec, param_pspecs, tp_forward_logits, tp_place

__all__ = [
    "Spec",
    "dryrun_multichip",
    "ep_place",
    "ep_pspecs",
    "get_mesh",
    "init_distributed",
    "make_sharded_train_step",
    "pp_decode",
    "pp_fit_encode",
    "param_pspecs",
    "shard_batch",
    "sharded_autoregressive_sample",
    "tp_forward_logits",
    "tp_place",
]
