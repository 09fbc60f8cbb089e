"""Pretraining of TabICA on the synthetic task prior (counterpart of
``npe_pfn_tpu/pretrain``): ``prior`` makes task batches on the device,
``train`` runs the loop, ``warmstart`` adapts a checkpoint's head.
``python -m npe_pfn_tpu_torch.pretrain`` is the command line."""
