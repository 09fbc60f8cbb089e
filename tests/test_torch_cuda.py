"""Card-only tests of the PyTorch/CUDA port (marker ``cuda``; skipped without
a card). They import nothing of JAX, so they run on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.) The kernel is
held against its plain version on the same card inputs: f32 to 1e-5, bf16
to 1e-2 (bf16 output and P rounding). The model paths run a small model with
random weights made by numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel, bar_distribution, transformer
from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy
from npe_pfn_tpu_torch.ops import flash_attention as fa
from npe_pfn_tpu_torch.utils import pytree_io
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

CASES = [
    # (b, lq, lk, h, hd, mask kind)
    (3, 64, 64, 2, 32, "shared"),
    (3, 96, 160, 2, 16, "shared"),
    (2, 100, 150, 2, 128, "batch"),
    (4, 32, 96, 2, 32, "batch_empty_row"),
    (2, 16, 40, 1, 16, "shared_empty"),
    (2, 257, 513, 2, 128, "batch"),
    (4, 96, 160, 2, 128, "batch_one_key"),
]


def _mask(kind, b, lk, gen, dev):
    if kind == "shared":
        return torch.arange(lk, device=dev) < lk - 7
    if isinstance(kind, int):  # the first ``kind`` keys valid, one mask for all rows
        return torch.arange(lk, device=dev) < kind
    m = torch.arange(lk, device=dev)[None] < torch.randint(1, lk + 1, (b, 1), generator=gen,
                                                           device=dev)
    if kind == "batch_empty_row":
        m[1] = False
    if kind == "batch_one_key":
        m[0] = torch.arange(lk, device=dev) < 1
    if kind == "shared_empty":
        return torch.zeros(lk, dtype=torch.bool, device=dev)
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,hd,kind", CASES)
def test_kernel_matches_plain(cuda_device, dtype, b, lq, lk, h, hd, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((b, lq, h, hd), (b, lk, h, hd), (b, lk, h, hd)))
    m = _mask(kind, b, lk, gen, cuda_device)
    before = fa.flash_row_attention.launches
    out = fa.flash_row_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert fa.flash_row_attention.launches == before + 1
    ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
    ref = ref * fa._any_valid_gate(m, torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


def test_kernel_reads_strided_layout(cuda_device):
    """q/k/v as views into a wider [B, L, 3, H, hd] buffer: read through the
    strides, no copy."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 300, 3, 2, 32, generator=gen, device=cuda_device).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    m = torch.ones(300, dtype=torch.bool, device=cuda_device)
    out = fa.flash_row_attention(q, k, v, m)
    ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    m = torch.ones(64, dtype=torch.bool, device=cuda_device)
    bad_hd = torch.randn(1, 64, 2, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_row_attention(bad_hd, bad_hd, bad_hd, m)
    half = torch.randn(1, 64, 2, 32, device=cuda_device).half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_row_attention(half, half, half, m)
    wide = torch.randn(1, 64, 2, 33, device=cuda_device)[..., 1:]
    with pytest.raises(ValueError):
        fa.flash_row_attention(wide, wide, wide, m)


def _random_model(d=64, heads=2, layers=2, f=12, bars=32, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    hd, hid = d // heads, 4 * d

    def nrm(*shape, s=0.05):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    flat = {"embed/w_feat": nrm(d, s=1.0), "embed/b_feat": nrm(d), "embed/w_y": nrm(d, s=1.0),
            "embed/b_y": nrm(d), "embed/y_missing": nrm(d, s=1.0),
            "head/ln/scale": 1 + nrm(d), "head/ln/bias": nrm(d), "head/w1": nrm(d, 2 * d),
            "head/b1": nrm(2 * d), "head/w2": nrm(2 * d, bars), "head/b2": nrm(bars),
            "blocks/mlp/w1": nrm(layers, d, hid), "blocks/mlp/b1": nrm(layers, hid),
            "blocks/mlp/w2": nrm(layers, hid, d), "blocks/mlp/b2": nrm(layers, d)}
    for ln in ("ln_feat", "ln_row", "ln_mlp"):
        flat[f"blocks/{ln}/scale"] = 1 + nrm(layers, d)
        flat[f"blocks/{ln}/bias"] = nrm(layers, d)
    for att in ("feat_attn", "row_attn"):
        for w in ("wq", "wk", "wv"):
            flat[f"blocks/{att}/{w}"] = nrm(layers, d, heads, hd, s=0.2)
        flat[f"blocks/{att}/wo"] = nrm(layers, heads, hd, d)
        flat[f"blocks/{att}/bo"] = nrm(layers, d)
    cfg = TabICAConfig(d_model=d, num_heads=heads, num_layers=layers, max_features=f,
                       num_bars=bars, dtype=dtype, scores_dtype=dtype)
    return TabICAModel(cfg=cfg, params=params_from_numpy(flat, "cuda"),
                       borders=bar_distribution.make_borders(bars, device="cuda"))


def test_transformer_kernel_path_matches_dense(cuda_device):
    """f32 model: row attention through the kernel ('auto' on CUDA) against
    the dense path ('off'), joint forward and encode + decode."""
    model = _random_model()
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x_ctx = torch.randn(300, 12, generator=gen, device=cuda_device)
    y_ctx = torch.randn(300, generator=gen, device=cuda_device)
    x_qry = torch.randn(100, 12, generator=gen, device=cuda_device)
    ctx_mask = torch.arange(300, device=cuda_device) < 280
    before = fa.flash_row_attention.launches
    auto = transformer.forward(model.cfg, model.params, x_ctx, y_ctx, x_qry, ctx_mask=ctx_mask)
    assert fa.flash_row_attention.launches - before == 2 * model.cfg.num_layers
    off_cfg = dataclasses.replace(model.cfg, flash="off")
    dense = transformer.forward(off_cfg, model.params, x_ctx, y_ctx, x_qry, ctx_mask=ctx_mask)
    torch.testing.assert_close(auto, dense, rtol=1e-4, atol=1e-4)
    cache = transformer.encode_context(model.cfg, model.params, x_ctx, y_ctx, ctx_mask=ctx_mask)
    dec = transformer.decode_queries(model.cfg, model.params, cache, x_qry, ctx_mask=ctx_mask)
    torch.testing.assert_close(dec, auto, rtol=1e-5, atol=1e-5)


def test_npepfn_samples_on_card(cuda_device):
    model = _random_model(f=16, dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    theta = torch.randn(600, 3, generator=gen, device=cuda_device)
    x = theta @ torch.randn(3, 5, generator=gen, device=cuda_device) + 0.3 * torch.randn(
        600, 5, generator=gen, device=cuda_device)
    est = NPEPFN(model=model, filter_context_size=256, qry_chunk=256)
    est.append_simulations(theta, x)
    before = fa.flash_row_attention.launches
    s, lp = est.sample(500, x[0], return_log_probs=True)
    assert s.shape == (500, 3) and lp.shape == (500,)
    assert torch.isfinite(s).all() and torch.isfinite(lp).all()
    # 3 dims x 2 layers x (1 encode + 2 decode chunks of 256)
    assert fa.flash_row_attention.launches - before == 18


# --- Training path: lse forward, backward, autograd Function ---------------
# Output: f32 1e-5 absolute; bf16 1e-2 per element and per slice (bf16
# output and P rounding). Gradients per slice: f32 1e-5 (f32 FMA in both,
# sums in another order), bf16 2e-2 (the kernel rounds P and dS to bf16
# before their products; the plain version keeps f32). "Per slice" is
# max |kernel - plain| / max |plain| within each (batch row, head): with
# per-batch masks a row with few keys has gradients far larger than a row
# with many, and one scale for the whole tensor would hide a wrong long row.
# dq and dk of a row with one valid key are zero in exact arithmetic (P is
# one-hot, so dS = 0); the plain version holds only f32 rounding there, so
# those rows are read against the whole tensor's max |plain|.


def _slice_rel_err(out, ref, zero_rows=None):
    """Largest max |out - ref| / max |ref| over the (b, h) slices of two
    [B, L, H, hd] tensors; a slice whose ref is all zero must match exactly.
    Batch rows set in ``zero_rows`` are read against the tensor's max |ref|."""
    err = (out.float() - ref.float()).abs().amax(dim=(1, 3))
    scale = ref.float().abs().amax(dim=(1, 3))
    if zero_rows is not None:
        scale = torch.where(zero_rows[:, None], ref.float().abs().max(), scale)
    exact = torch.where(err == 0, 0.0, float("inf"))
    return torch.where(scale > 0, err / scale.clamp_min(1e-30), exact).max().item()


def _qkv_do(b, lq, lk, h, hd, dtype, gen, dev):
    return tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                 for s in ((b, lq, h, hd), (b, lk, h, hd), (b, lk, h, hd), (b, lq, h, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,hd,kind", CASES)
def test_lse_and_backward_kernels_match_plain(cuda_device, dtype, b, lq, lk, h, hd, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, d_out = _qkv_do(b, lq, lk, h, hd, dtype, gen, cuda_device)
    m = _mask(kind, b, lk, gen, cuda_device)
    launches = (fa.flash_row_attention_lse.launches, fa.flash_row_attention_bwd.launches)
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    grads = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    torch.cuda.synchronize()
    assert (fa.flash_row_attention_lse.launches, fa.flash_row_attention_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    ref_out, ref_lse = fa.reference_row_attention_lse(q.float(), k.float(), v.float(), m)
    gate = fa._any_valid_gate(m, torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref_out * gate, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _slice_rel_err(out, ref_out * gate) <= tol
    valid = (m.float().sum(dim=-1) > 0).expand(b)  # batch rows with a valid key
    torch.testing.assert_close(lse[valid], ref_lse[valid], rtol=1e-5, atol=1e-5)
    ref_grads = fa.reference_row_attention_bwd(q, k, v, m, out, lse, d_out)
    grad_tol = 1e-5 if dtype == torch.float32 else 2e-2
    one_key = (m.sum(dim=-1) == 1).reshape(-1).expand(b)
    for g, r, z in zip(grads, ref_grads, (one_key, one_key, None)):
        assert _slice_rel_err(g, r, z) <= grad_tol


def test_backward_repeats_bit_for_bit(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, d_out = _qkv_do(16, 300, 300, 2, 128, torch.bfloat16, gen, cuda_device)
    m = _mask("batch", 16, 300, gen, cuda_device)
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    first = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    second = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_no_grad_kernel_raises_under_grad(cuda_device):
    """The inference kernel's output has no grad_fn: a CUDA call that would
    need one raises instead of silently dropping the gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, _ = _qkv_do(2, 64, 64, 2, 32, torch.float32, gen, cuda_device)
    m = torch.ones(64, dtype=torch.bool, device=cuda_device)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="flash_row_attention_trainable"):
        fa.flash_row_attention(q, k, v, m)
    with torch.no_grad():
        fa.flash_row_attention(q, k, v, m)
    out = fa.flash_row_attention_trainable(q, k, v, m)
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("remat", [False, True])
def test_train_gradients_kernel_path_match_dense(cuda_device, remat):
    """f32 model: loss and gradients of batch_loss through the kernels
    ('auto' on CUDA) against the dense path ('off'); per-step launch counts."""
    from npe_pfn_tpu_torch.pretrain import prior, train

    model = _random_model()
    pcfg = prior.PriorConfig(num_features=12, num_ctx=200, num_qry=40, max_active_features=10)
    batch = prior.sample_tasks(torch.Generator(device=cuda_device).manual_seed(7), 3, pcfg)
    results = {}
    for flash in ("auto", "off"):
        cfg = dataclasses.replace(model.cfg, flash=flash)
        named = {n: p.detach().requires_grad_(True)
                 for n, p in pytree_io.flatten(model.params).items()}
        leaves = list(named.values())
        params = pytree_io.unflatten(named)
        before = (fa.flash_row_attention_lse.launches, fa.flash_row_attention_bwd.launches)
        loss = train.batch_loss(cfg, model.borders, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        used = (fa.flash_row_attention_lse.launches - before[0],
                fa.flash_row_attention_bwd.launches - before[1])
        n = model.cfg.num_layers
        # The last layer's context row attention feeds only the final context
        # state, which the loss never reads: autograd skips its backward.
        assert used == (((4 if remat else 2) * n, 2 * n - 1) if flash == "auto" else (0, 0))
        results[flash] = (loss, grads)
    torch.testing.assert_close(results["auto"][0], results["off"][0], rtol=1e-4, atol=1e-5)
    for g, r in zip(results["auto"][1], results["off"][1]):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-5)


# --- The Hopper (wgmma) design at its edges: bf16, head_dim 128 ------------
# Same tolerances as above: output 1e-2 elementwise and per slice, lse 1e-5,
# gradients 2e-2 per slice (one-key rows' dq/dk against the tensor's max).

EDGE = (1, 63, 64, 65, 127, 128, 129)  # around the 64- and 128-row tiles


def _check_wgmma_fwd_bwd(q, k, v, m, d_out):
    """Forward, lse forward and backward through the wgmma design against
    the plain versions; every call must take that design."""
    b = q.shape[0]
    before = [(w.wgmma_launches, w.wmma_launches)
              for w in (fa.flash_row_attention, fa.flash_row_attention_lse,
                        fa.flash_row_attention_bwd)]
    out_nolse = fa.flash_row_attention(q, k, v, m)
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    grads = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    torch.cuda.synchronize()
    after = [(w.wgmma_launches, w.wmma_launches)
             for w in (fa.flash_row_attention, fa.flash_row_attention_lse,
                       fa.flash_row_attention_bwd)]
    assert all(a == (x + 1, y) for a, (x, y) in zip(after, before))
    assert torch.equal(out_nolse, out)
    ref_out, ref_lse = fa.reference_row_attention_lse(q.float(), k.float(), v.float(), m)
    ref_out = ref_out * fa._any_valid_gate(m, torch.float32)
    torch.testing.assert_close(out.float(), ref_out, rtol=1e-2, atol=1e-2)
    assert _slice_rel_err(out, ref_out) <= 1e-2
    valid = (m.float().sum(dim=-1) > 0).expand(b)
    torch.testing.assert_close(lse[valid], ref_lse[valid], rtol=1e-5, atol=1e-5)
    ref_grads = fa.reference_row_attention_bwd(q, k, v, m, out, lse, d_out)
    one_key = (m.sum(dim=-1) == 1).reshape(-1).expand(b)
    checks = list(zip(grads, ref_grads, (one_key, one_key, None)))
    if bool(valid.any()) and bool(one_key[valid].all()):
        # Every row has one key (Lk = 1): dq and dk are zero in exact
        # arithmetic and rounding residue on both sides, so the tensor's own
        # max is no scale; they are read against max |dv| instead.
        scale = ref_grads[2].float().abs().max()
        for g, r in zip(grads[:2], ref_grads[:2]):
            assert (g.float() - r.float()).abs().max() <= 2e-2 * scale
        checks = checks[2:]
    for g, r, z in checks:
        assert _slice_rel_err(g, r, z) <= 2e-2
    empty = ~valid
    for t in (out, *grads):
        assert bool((t[empty] == 0).all())


@pytest.mark.parametrize("lk", EDGE)
@pytest.mark.parametrize("lq", EDGE)
def test_wgmma_design_at_tile_edges(cuda_device, lq, lk):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, d_out = _qkv_do(2, lq, lk, 2, 128, torch.bfloat16, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, _mask("batch", 2, lk, gen, cuda_device), d_out)


def test_wgmma_design_ragged_long(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, d_out = _qkv_do(3, 1000, 1500, 2, 128, torch.bfloat16, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, _mask("shared", 3, 1500, gen, cuda_device), d_out)


def test_wgmma_design_reads_strided_layout(cuda_device):
    """bf16 head_dim 128 q/k/v as views into a [B, L, 3, H, hd] buffer, for
    the forward and the backward (read through the strides, no copy)."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    qkv = torch.randn(2, 300, 3, 2, 128, generator=gen, device=cuda_device).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    d_out = torch.randn(2, 300, 2, 128, generator=gen, device=cuda_device).bfloat16()
    _check_wgmma_fwd_bwd(q, k, v, _mask("batch", 2, 300, gen, cuda_device), d_out)


@pytest.mark.parametrize("kind", ["batch_one_key", "batch_empty_row", "shared_empty"])
def test_wgmma_design_degenerate_masks(cuda_device, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, d_out = _qkv_do(4, 200, 333, 2, 128, torch.bfloat16, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, _mask(kind, 4, 333, gen, cuda_device), d_out)


def test_wgmma_design_small_grid(cuda_device):
    """B x H x tiles well below the card's 132 SMs."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v, d_out = _qkv_do(1, 200, 260, 1, 128, torch.bfloat16, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, _mask("batch", 1, 260, gen, cuda_device), d_out)


def test_other_shapes_take_the_wmma_design(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    m = torch.ones(96, dtype=torch.bool, device=cuda_device)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 32), (torch.float32, 16)):
        q, k, v, d_out = _qkv_do(2, 80, 96, 2, hd, dtype, gen, cuda_device)
        before = (fa.flash_row_attention_lse.wmma_launches, fa.flash_row_attention_bwd.wmma_launches,
                  fa.flash_row_attention_lse.wgmma_launches)
        out, lse = fa.flash_row_attention_lse(q, k, v, m)
        fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
        assert (fa.flash_row_attention_lse.wmma_launches, fa.flash_row_attention_bwd.wmma_launches,
                fa.flash_row_attention_lse.wgmma_launches) == (before[0] + 1, before[1] + 1,
                                                               before[2])


# --- The inference kernel at the shapes of the rest of the API ---------------
# bf16, H 2, hd 128, against the plain version to 1e-2 (per element and per
# (batch row, head) slice): context-ensemble members (B 100 = 4 members x 25
# tokens, 2048 queries against 512 keys, per-member mask rows), the
# per-observation contexts of sample_batched_filtered (B 136 and 200 = 8
# observations x 17 or 25 tokens, 1024 queries against 2048 keys, per-batch
# mask rows) and the CachedPosterior precompute (B 250 = 10 dims x 25 tokens,
# 2048 x 2048, one shared mask). Then the evaluation harness's: B 9
# (two_moons' tokens) to 33 (gaussian_bump_image's), contexts of 10 and 1000
# simulations (every key valid) and of num_cal 1000 padded to 1024 rows, 256
# posterior samples per query chunk.
API_SHAPES = [(100, 2048, 512, "batch"), (136, 1024, 2048, "batch"),
              (200, 1024, 2048, "batch"), (250, 2048, 2048, "shared"),
              (9, 10, 10, 10), (9, 256, 10, 10), (33, 1000, 1000, 1000), (33, 256, 1000, 1000),
              (9, 1024, 1024, 1000), (33, 256, 1024, 1000)]


@pytest.mark.parametrize("b,lq,lk,kind", API_SHAPES)
def test_kernel_at_api_shapes(cuda_device, b, lq, lk, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).bfloat16()
               for s in ((b, lq, 2, 128), (b, lk, 2, 128), (b, lk, 2, 128)))
    m = _mask(kind, b, lk, gen, cuda_device)
    before = (fa.flash_row_attention.wgmma_launches, fa.flash_row_attention.wmma_launches)
    out = fa.flash_row_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert (fa.flash_row_attention.wgmma_launches,
            fa.flash_row_attention.wmma_launches) == (before[0] + 1, before[1])
    ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)
    assert _slice_rel_err(out, ref) <= 1e-2


# --- The inference kernel at the shapes of sequential inference --------------
# bf16, H 2, hd 128, every launch of the wgmma design, against the plain
# version to 1e-2 x max(1, max|plain|) (chip_smoke.py phase 3's tolerance; no
# shape here has 10 keys or fewer) and per (batch row, head) slice: the
# PosteriorSupport precompute at 1024 context rows (B 250 = 10 dims x 25
# tokens) and its candidate scoring (B 25, 2048-row chunks against 1024 keys);
# the classifier heads' 512-row context (B 11 = 10 θ features + 1) encoded and
# decoded against the ratio log_prob's 10,240 and the restricted prior's
# 16,384 query rows; audit_binary's tasks (B 6, 256 x 256); the unconditional
# estimator's clusters (B 9 and 17, 512-row contexts, some padded, 1024-row
# query chunks); two_moons' refinement at 1000 simulations (B 9, 1024 rows);
# the CLI's TSNPE (512 and 1024 context rows, 1024-row chunks). These are the
# shapes chip_smoke.py phases 19-21 launched on the H100.
SEQ_SHAPES = [(250, 1024, 1024, 1024), (25, 2048, 1024, 1024), (11, 512, 512, 512),
              (11, 10_240, 512, 512), (11, 16_384, 512, 512), (6, 256, 256, 256),
              (9, 512, 512, 400), (17, 512, 512, 512), (9, 1024, 512, 400),
              (17, 1024, 512, 512), (9, 1024, 1024, 1000), (9, 2048, 1024, 1000),
              (250, 512, 512, 512), (25, 1024, 512, 512), (17, 1024, 1024, 1024),
              (25, 1024, 1024, 1024)]


@pytest.mark.parametrize("b,lq,lk,kind", SEQ_SHAPES)
def test_kernel_at_sequential_shapes(cuda_device, b, lq, lk, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).bfloat16()
               for s in ((b, lq, 2, 128), (b, lk, 2, 128), (b, lk, 2, 128)))
    m = _mask(kind, b, lk, gen, cuda_device)
    before = (fa.flash_row_attention.wgmma_launches, fa.flash_row_attention.wmma_launches)
    out = fa.flash_row_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert (fa.flash_row_attention.wgmma_launches,
            fa.flash_row_attention.wmma_launches) == (before[0] + 1, before[1])
    ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
    tol = 1e-2 * max(1.0, ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= tol
    assert _slice_rel_err(out, ref) <= 1e-2


# --- Row-pooled and MoE models (slice 7) ---------------------------------------
# Row pooling sends K slots per row through the row attention: at the
# pretrain_v7 width with 8 slots the training shapes are B 64 (8 datasets x 8
# slots) x 768 x 768 and 64 x 128 x 768 with per-dataset mask rows, and a
# request's encode and decode chunks B 8 x 2048 x 2048. Tolerances as above.


@pytest.mark.parametrize("b,lq,lk", [(64, 768, 768), (64, 128, 768)])
def test_wgmma_design_at_pooled_training_shapes(cuda_device, b, lq, lk):
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    q, k, v, d_out = _qkv_do(b, lq, lk, 2, 128, torch.bfloat16, gen, cuda_device)
    rows = _mask("batch", 8, lk, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, rows.repeat_interleave(b // 8, dim=0), d_out)


def test_kernel_at_pooled_inference_shape(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q, k, v = (torch.randn((8, 2048, 2, 128), generator=gen, device=cuda_device).bfloat16()
               for _ in range(3))
    m = _mask("shared", 8, 2048, gen, cuda_device)
    before = fa.flash_row_attention.wgmma_launches
    out = fa.flash_row_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert fa.flash_row_attention.wgmma_launches == before + 1
    ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
    assert (out.float() - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())
    assert _slice_rel_err(out, ref) <= 1e-2


@pytest.mark.parametrize("over", [dict(row_pool_slots=4), dict(num_experts=4, moe_top_k=2)],
                         ids=["pooled", "moe"])
def test_pooled_and_moe_kernel_path_match_dense(cuda_device, over):
    """f32 pooled and MoE models from init_params: the joint forward, encode
    + decode and batch_loss with its gradients through the kernels against
    the dense path, with the launches a step takes (the MoE aux makes the
    last layer's context row attention reach the loss: one more backward)."""
    from npe_pfn_tpu_torch.pretrain import prior, train

    cfg = TabICAConfig(d_model=64, num_heads=2, num_layers=2, max_features=12, num_bars=32,
                       dtype="float32", scores_dtype="float32", **over)
    model = TabICAModel.create(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x_ctx = torch.randn(300, 12, generator=gen, device=cuda_device)
    y_ctx = torch.randn(300, generator=gen, device=cuda_device)
    x_qry = torch.randn(100, 12, generator=gen, device=cuda_device)
    off = dataclasses.replace(cfg, flash="off")
    with torch.no_grad():
        auto = transformer.forward(cfg, model.params, x_ctx, y_ctx, x_qry)
        dense = transformer.forward(off, model.params, x_ctx, y_ctx, x_qry)
    torch.testing.assert_close(auto, dense, rtol=1e-4, atol=1e-4)
    cache = transformer.encode_context(cfg, model.params, x_ctx, y_ctx)
    slots = over.get("row_pool_slots") or 13
    assert tuple(cache[0][0].shape) == (slots, 300, 2, 32)
    torch.testing.assert_close(transformer.decode_queries(cfg, model.params, cache, x_qry), auto,
                               rtol=1e-4, atol=1e-4)
    pcfg = prior.PriorConfig(num_features=12, num_ctx=200, num_qry=40, max_active_features=10)
    batch = prior.sample_tasks(torch.Generator(device=cuda_device).manual_seed(23), 3, pcfg)
    results = {}
    for c in (cfg, off):
        named = {n: p.detach().requires_grad_(True)
                 for n, p in pytree_io.flatten(model.params).items()}
        before = (fa.flash_row_attention_lse.launches, fa.flash_row_attention_bwd.launches)
        loss = train.batch_loss(c, model.borders, pytree_io.unflatten(named), batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        used = (fa.flash_row_attention_lse.launches - before[0],
                fa.flash_row_attention_bwd.launches - before[1])
        n = cfg.num_layers
        want = (4 * n, 2 * n - (0 if cfg.num_experts else 1))
        assert used == (want if c.flash == "auto" else (0, 0))
        results[c.flash] = (loss, grads)
    torch.testing.assert_close(results["auto"][0], results["off"][0], rtol=1e-4, atol=1e-5)
    for g, r in zip(results["auto"][1], results["off"][1]):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-5)


def test_flow_npe_fits_on_card(cuda_device):
    from npe_pfn_tpu_torch import FlowNPE, get_task

    task = get_task("gaussian_linear", dim=2, device=cuda_device)
    theta, x = task.simulate(torch.Generator(device=cuda_device).manual_seed(0), 1000)
    flow = FlowNPE(dim_theta=2, dim_x=2, max_epochs=20, patience=5, device=cuda_device)
    assert 1 <= flow.fit(theta, x) <= 20
    assert all(w.is_cuda for net in flow.params for w, _ in net)
    x_o = torch.tensor([0.8, -0.5], device=cuda_device)
    s = flow.sample(512, x_o, generator=torch.Generator(device=cuda_device).manual_seed(1))
    lp = flow.log_prob(s, x_o)
    assert s.shape == (512, 2) and bool(torch.isfinite(s).all() and torch.isfinite(lp).all())


# --- npe_pfn_tpu_torch.parallel on the card: one NCCL group of one rank ------
# (NCCL takes one card per rank; a multi-rank run needs as many cards.)


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    import torch.distributed as dist

    from npe_pfn_tpu_torch.parallel import init_distributed

    dev = init_distributed(0, 1, "file://" + str(tmp_path_factory.mktemp("nccl") / "rdzv"))
    yield dev
    dist.destroy_process_group()


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("experts", [0, 4])
def test_parallel_paths_match_single_device(nccl_rank, experts):
    """Each parallel path at world size 1 against its single-device path:
    bf16 at head_dim 128 (the wgmma design), logits within 1e-3 x
    max(1, |logit|); sharded sampling bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from npe_pfn_tpu_torch.estimator import autoregressive_sample
    from npe_pfn_tpu_torch.models import regressor
    from npe_pfn_tpu_torch.parallel import (ep_place, get_mesh, pp_decode, pp_fit_encode,
                                            sharded_autoregressive_sample, tp_place)
    from npe_pfn_tpu_torch.parallel.context_sharded import sp_decode, sp_fit_encode

    dev = nccl_rank
    gen = torch.Generator(device=dev).manual_seed(30)
    cfg = TabICAConfig(d_model=256, num_heads=2, num_layers=2, max_features=16, num_bars=64,
                       dtype="bfloat16", scores_dtype="bfloat16", num_experts=experts)
    model = TabICAModel.create(gen, cfg)
    x_ctx, x_qry = torch.randn(300, 12, generator=gen, device=dev), torch.randn(
        64, 12, generator=gen, device=dev)
    y_ctx = torch.randn(300, generator=gen, device=dev)
    ctx_mask = torch.rand(300, generator=gen, device=dev) > 0.1

    def logits(m):
        return regressor.predict_logits(m, regressor.fit_encode(m, x_ctx, y_ctx,
                                                                ctx_mask=ctx_mask), x_qry)

    ref = logits(model)
    if experts:
        placed = ep_place(get_mesh(1, axis="ep"), model)
        assert _rel_err(logits(placed), ref) <= 1e-3
        return
    mesh_sp = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "sp"))
    for mode in ("gather", "ring"):
        fitted = sp_fit_encode(mesh_sp, model, x_ctx, y_ctx, ctx_mask=ctx_mask, row_attn=mode)
        assert _rel_err(sp_decode(mesh_sp, model, fitted, x_qry, row_attn=mode), ref) <= 1e-3
    assert _rel_err(logits(tp_place(get_mesh(1, axis="tp"), model)), ref) <= 1e-3
    mesh_pp = get_mesh(1, axis="pp")
    fitted = pp_fit_encode(mesh_pp, model, x_ctx, y_ctx, ctx_mask=ctx_mask)
    assert _rel_err(pp_decode(mesh_pp, model, fitted, x_qry, num_microbatches=2), ref) <= 1e-3
    theta_ctx = torch.randn(300, 2, generator=gen, device=dev)
    args = (theta_ctx, x_ctx[:, :3], ctx_mask, x_qry[:, :3])
    got = sharded_autoregressive_sample(get_mesh(1), model, *args,
                                        torch.Generator(device=dev).manual_seed(5), 32)
    want = autoregressive_sample(model, *args, torch.Generator(device=dev).manual_seed(5), 32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dp_step_equals_train_step(nccl_rank):
    from npe_pfn_tpu_torch.parallel import get_mesh, make_sharded_train_step
    from npe_pfn_tpu_torch.pretrain import prior, train

    dev = nccl_rank
    model = _random_model(d=256, dtype="bfloat16")
    tcfg = train.TrainConfig(num_datasets=2, warmup_steps=0, max_steps=10)
    pcfg = prior.PriorConfig(num_features=12, num_ctx=200, num_qry=40, max_active_features=10)
    opt_state = train.make_optimizer(tcfg).init(model.params)
    step, place = make_sharded_train_step(get_mesh(1), model.cfg, tcfg, pcfg)
    dp = place(model.params, opt_state)
    one = (model.params, opt_state)
    for i in range(2):
        p, s, loss, gnorm = step(*dp, model.borders, torch.Generator(device=dev).manual_seed(i))
        p1, s1, loss1, gnorm1 = train.train_step(model.cfg, tcfg, pcfg, *one, model.borders,
                                                 torch.Generator(device=dev).manual_seed(i))
        dp, one = (p, s), (p1, s1)
        assert (loss.item(), gnorm.item()) == (loss1.item(), gnorm1.item())
    for name, t in pytree_io.flatten(dp[0]).items():
        assert torch.equal(t, pytree_io.flatten(one[0])[name]), name


def test_ring_merge_of_the_lse_kernel(cuda_device):
    """The lse kernel over 2048 keys in 4 slices (one fully masked), merged
    in f32, against one call over all keys: output within phase 3's bf16
    bound, lse within 1e-4 relative."""
    from npe_pfn_tpu_torch.parallel.context_sharded import merge_partials

    gen = torch.Generator(device=cuda_device).manual_seed(31)
    q, k, v = (torch.randn((25, 2048, 2, 128), generator=gen, device=cuda_device).bfloat16()
               for _ in range(3))
    m = torch.rand(2048, generator=gen, device=cuda_device) > 0.2
    m[512:1024] = False
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    o_acc = lse_acc = None
    for sl in torch.arange(2048, device=cuda_device).chunk(4):
        o_acc, lse_acc = merge_partials(o_acc, lse_acc,
                                        *fa.flash_row_attention_lse(q, k[:, sl], v[:, sl], m[sl]))
    assert bool(torch.isfinite(o_acc).all())
    assert (o_acc - out.float()).abs().max().item() <= 1e-2 * max(1.0, out.float().abs().max())
    assert ((lse_acc - lse).abs() / lse.abs().clamp_min(1.0)).max().item() <= 1e-4


@pytest.mark.parametrize("lq,lk", [(2048, 2048), (128, 768)])
def test_kernels_at_one_head(cuda_device, lq, lk):
    """A 2-way tensor-parallel rank of the shipped checkpoint runs one head
    of 128: the forward, lse forward and backward there against the plain
    versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    q, k, v, d_out = _qkv_do(20, lq, lk, 1, 128, torch.bfloat16, gen, cuda_device)
    _check_wgmma_fwd_bwd(q, k, v, _mask("batch", 20, lk, gen, cuda_device), d_out)


def test_dryrun_on_card(cuda_device, capfd):
    from npe_pfn_tpu_torch.parallel import dryrun_multichip

    dryrun_multichip(1)
    assert "sharded sampling on 1 ranks OK" in capfd.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA cards, one each"):
        dryrun_multichip(torch.cuda.device_count() + 1)
