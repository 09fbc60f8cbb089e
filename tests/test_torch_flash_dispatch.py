"""The row-attention kernels' design dispatch, checked without a card.

Each CUDA source holds two designs: the Hopper one ("wgmma": TMA loads into an
mbarrier ring, wgmma with register accumulators) for bf16 at head_dim 128, and
the WMMA/FMA one for f32 and head_dim 16 or 32. The wrappers pick one with
``kernel_design`` before they launch. These tests hold that choice, the
launchers it leads to (by inspection: none of them may reach a plain
version), the operands the Hopper design is given, and the build's cache key.
"""

import inspect

import pytest
import torch

from npe_pfn_tpu_torch.ops import _build
from npe_pfn_tpu_torch.ops import flash_attention as fa

WRAPPERS = (fa.flash_row_attention, fa.flash_row_attention_lse, fa.flash_row_attention_bwd)
PLAIN = ("reference_row_attention", "reference_row_attention_lse",
         "reference_row_attention_bwd", "_attend", "_masked_scores")


@pytest.mark.parametrize("dtype,hd,design", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "wmma"),
    (torch.bfloat16, 16, "wmma"),
    (torch.float32, 128, "wmma"),
    (torch.float32, 32, "wmma"),
    (torch.float32, 16, "wmma"),
])
def test_design_is_chosen_by_dtype_and_head_dim(dtype, hd, design):
    assert fa.kernel_design(dtype, hd) == design
    assert fa.kernel_design(dtype, hd) == fa.kernel_design(dtype, hd)  # no state


def test_every_design_has_a_forward_and_a_backward_launcher():
    assert tuple(fa.FWD_LAUNCHERS) == fa.DESIGNS == tuple(fa.BWD_LAUNCHERS)


@pytest.mark.parametrize("launcher", [
    *fa.FWD_LAUNCHERS.values(), *fa.BWD_LAUNCHERS.values(), fa._launch, fa._launch_bwd,
], ids=lambda f: f.__name__)
def test_cuda_launchers_never_reach_a_plain_version(launcher):
    names = set(launcher.__code__.co_names)
    assert not names & set(PLAIN), f"{launcher.__name__} names {names & set(PLAIN)}"
    assert "try" not in inspect.getsource(launcher).split()  # no fallback path


def test_the_cuda_entry_dispatches_through_the_design():
    for fn, table in ((fa._launch, "FWD_LAUNCHERS"), (fa._launch_bwd, "BWD_LAUNCHERS")):
        assert {"kernel_design", table} <= set(fn.__code__.co_names)
    lib_of = {fa._launch_wgmma: "flash_row_attention_fwd_wgmma",
              fa._launch_wmma: "flash_row_attention_fwd",
              fa._launch_bwd_wgmma: "flash_row_attention_bwd_wgmma",
              fa._launch_bwd_wmma: "flash_row_attention_bwd"}
    for fn, entry in lib_of.items():
        assert entry in fn.__code__.co_names


def test_every_wrapper_counts_launches_per_design():
    for w in WRAPPERS:
        assert isinstance(w.launches, int)
        for design in fa.DESIGNS:
            assert isinstance(getattr(w, f"{design}_launches"), int)


def test_cpu_calls_count_no_launch():
    q = torch.randn(2, 20, 2, 128).bfloat16()
    m = torch.ones(20, dtype=torch.bool)
    before = [(w.launches, w.wgmma_launches, w.wmma_launches) for w in WRAPPERS]
    out, lse = fa.flash_row_attention_lse(q, q, q, m)
    fa.flash_row_attention_bwd(q, q, q, m, out, lse, q)
    fa.flash_row_attention(q, q, q, m)
    assert [(w.launches, w.wgmma_launches, w.wmma_launches) for w in WRAPPERS] == before


@pytest.mark.parametrize("shape", [(130,), (3, 130), (2, 128), (1,)])
def test_wgmma_mask_operand_is_padded_with_masked_keys(shape):
    m = torch.rand(shape) > 0.3
    mask, stride = fa._mask_operand(m, 128)
    lk = shape[-1]
    assert mask.dtype == torch.float32 and mask.is_contiguous()
    assert mask.shape[-1] % 128 == 0 and mask.shape[-1] - lk < 128
    assert torch.equal(mask[..., :lk], m.float())
    assert bool((mask[..., lk:] == 0).all())
    assert stride == (0 if len(shape) == 1 else mask.shape[-1])
    plain, plain_stride = fa._mask_operand(m)  # the wmma design: unpadded
    assert torch.equal(plain, m.float()) and plain_stride == (0 if len(shape) == 1 else lk)


def test_tma_operand_copies_only_broadcasts():
    base = torch.randn(3, 40, 3, 2, 128)
    view = base.unbind(2)[1]
    assert fa._tma_operand(view) is view  # strided, read in place
    one = torch.randn(1, 40, 2, 128)
    assert fa._tma_operand(one) is one
    wide = torch.randn(1, 40, 2, 128).expand(4, 40, 2, 128)
    copy = fa._tma_operand(wide)
    assert copy is not wide and copy.is_contiguous() and torch.equal(copy, wide)


def test_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    """A change to a header under csrc/ must rebuild every source."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path("k.cu")
    assert _build.library_path("k.cu") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k.cu") != first


def test_the_sources_carry_both_designs():
    for source, entries in (("flash_row_attention.cu", ("flash_row_attention_fwd",
                                                        "flash_row_attention_fwd_lse",
                                                        "flash_row_attention_fwd_wgmma")),
                            ("flash_row_attention_bwd.cu", ("flash_row_attention_bwd",
                                                            "flash_row_attention_bwd_wgmma"))):
        text = (_build.CSRC_DIR / source).read_text()
        assert '#include "flash_hopper.cuh"' in text
        for entry in entries:
            assert f'extern "C" int {entry}(' in text
        assert "wgmma_rs_n128_mn" in text and "tma_load_rows" in text
