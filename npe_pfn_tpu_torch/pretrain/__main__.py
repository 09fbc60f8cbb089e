"""Pretrain TabICA on synthetic prior tasks with the PyTorch/CUDA port.

The counterpart of ``scripts/pretrain_tabica.py``, with the same flags plus
``--device`` (default CUDA; ``--device cpu`` runs a small configuration on the
CPU). The last fine-tune of the JAX package (``scripts/pretrain_v7.sh``):

    python -m npe_pfn_tpu_torch.pretrain --ckpt checkpoints/tabica_torch_v7.npz \\
        --log checkpoints/tabica_torch_v7_log.jsonl \\
        --init_from checkpoints/tabica_v6_best.npz --max_steps 24000 \\
        --num_datasets 8 --num_bars 1024 --num_ctx 768 --d_model 256 \\
        --num_heads 2 --num_layers 8 --lr 1.5e-4 --warmup_steps 1000 \\
        --scores_dtype bfloat16 --p_heteroscedastic 0.3 --p_heavy_tail 0.2 \\
        --p_categorical_feats 0.2 --p_multimodal 0.3 --p_sym_fold 0.7 \\
        --mm_mu_input_scale 0.3 --mm_sig_lo -1.7 --p_marginal_mixture 0.5
"""

import argparse

import torch

from ..models import transformer
from ..models.config import TabICAConfig
from . import prior, train


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m npe_pfn_tpu_torch.pretrain")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a card)")
    p.add_argument("--ckpt", default="checkpoints/tabica_torch.npz")
    p.add_argument("--log", default="checkpoints/tabica_torch_log.jsonl")
    p.add_argument("--max_steps", type=int, default=200_000)
    p.add_argument("--num_datasets", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_trunk", type=float, default=None,
                   help="peak lr for the transformer trunk (head uses --lr)")
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--init_from", default=None,
                   help="warm-start params from this checkpoint (head upsampled if "
                        "num_bars differs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_bars", type=int, default=256)
    p.add_argument("--max_features", type=int, default=32)
    p.add_argument("--num_ctx", type=int, default=384)
    p.add_argument("--num_qry", type=int, default=128)
    p.add_argument("--time_limit_s", type=float, default=None)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--val_every", type=int, default=500)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--p_heteroscedastic", type=float, default=0.0)
    p.add_argument("--p_heavy_tail", type=float, default=0.0)
    p.add_argument("--p_categorical_feats", type=float, default=0.0)
    p.add_argument("--p_multimodal", type=float, default=0.0)
    p.add_argument("--p_sym_fold", type=float, default=0.0)
    p.add_argument("--max_mixture_components", type=int, default=4)
    p.add_argument("--mm_mu_input_scale", type=float, default=1.0)
    p.add_argument("--mm_sig_lo", type=float, default=-2.5)
    p.add_argument("--p_marginal_mixture", type=float, default=0.0)
    p.add_argument("--feat_curriculum_steps", type=int, default=0)
    p.add_argument("--feat_curriculum_init", type=int, default=8)
    p.add_argument("--max_active_features", type=int, default=None,
                   help="active-feature cap (default min(24, max_features))")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steps with torch.profiler")
    p.add_argument("--profile_dir", default=None,
                   help="profiler output (default: a directory under TMPDIR)")
    p.add_argument("--scores_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--row_pool_slots", type=int, default=0,
                   help="row-attention slot pooling (not ported: > 0 raises)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num_experts", type=int, default=0,
                   help="mixture-of-experts MLP (not ported: > 0 raises)")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--flash", choices=["auto", "on", "off"], default="auto",
                   help="row attention: 'auto' takes the CUDA kernels on a card and "
                        "the dense path on the CPU")
    args = p.parse_args(argv)

    cfg = TabICAConfig(
        d_model=args.d_model, num_heads=args.num_heads, num_layers=args.num_layers,
        max_features=args.max_features, num_bars=args.num_bars, dtype=args.dtype,
        flash=args.flash, scores_dtype=args.scores_dtype, row_pool_slots=args.row_pool_slots,
        num_experts=args.num_experts, moe_top_k=args.moe_top_k,
    )
    tcfg = train.TrainConfig(
        num_datasets=args.num_datasets, lr=args.lr, lr_trunk=args.lr_trunk,
        warmup_steps=args.warmup_steps, max_steps=args.max_steps, seed=args.seed,
        ckpt_every=args.ckpt_every, val_every=args.val_every,
        feat_curriculum_steps=args.feat_curriculum_steps,
        feat_curriculum_init=args.feat_curriculum_init, moe_aux_weight=args.moe_aux_weight,
    )
    pcfg = prior.PriorConfig(
        num_features=args.max_features, num_ctx=args.num_ctx, num_qry=args.num_qry,
        max_active_features=(args.max_active_features if args.max_active_features is not None
                             else min(24, args.max_features)),
        p_heteroscedastic=args.p_heteroscedastic, p_heavy_tail=args.p_heavy_tail,
        p_categorical_feats=args.p_categorical_feats, p_multimodal=args.p_multimodal,
        p_sym_fold=args.p_sym_fold, max_mixture_components=args.max_mixture_components,
        mm_mu_input_scale=args.mm_mu_input_scale, mm_sig_lo=args.mm_sig_lo,
        p_marginal_mixture=args.p_marginal_mixture,
    )
    n_params = transformer.param_count(
        transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    print(f"model params: {n_params / 1e6:.2f}M")
    train.train(cfg, tcfg, pcfg, ckpt_path=args.ckpt, resume=not args.no_resume,
                log_path=args.log, time_limit_s=args.time_limit_s, init_from=args.init_from,
                profile_steps=args.profile_steps, profile_dir=args.profile_dir,
                device=args.device)


if __name__ == "__main__":
    main()
