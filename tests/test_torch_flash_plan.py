"""The flash-attention wrapper's launch planning, on the CPU: the head dim
each dtype's kernels run at, and the TMA maps the bf16 kernels read their
operands through (dims, byte strides, boxes), against hand-worked cases."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa, ops


@pytest.mark.parametrize("hd,bf16,fp32", [
    (1, 64, 16), (8, 64, 16), (16, 64, 16), (17, 64, 32), (32, 64, 32), (48, 64, 64),
    (63, 64, 64), (64, 64, 64), (65, 128, 128), (100, 128, 128), (128, 128, 128)])
def test_padded_head_dim_depends_on_dtype(hd, bf16, fp32):
    """bf16 runs at 64 or 128 (one swizzle mode for the tensor-core
    kernels), fp32 at the next of 16, 32, 64, 128."""
    assert ops.padded_head_dim(hd, torch.bfloat16) == bf16
    assert ops.padded_head_dim(hd, torch.float32) == fp32


@pytest.mark.parametrize("dtype,hd,want", [(torch.bfloat16, 16, 64), (torch.bfloat16, 48, 64),
                                           (torch.bfloat16, 64, 64), (torch.bfloat16, 96, 128),
                                           (torch.float32, 16, 16), (torch.float32, 48, 64), (torch.float32, 8, 16)])
def test_pad_head_dim_appends_zero_columns(dtype, hd, want):
    """The padding the card path applies before a launch: q, k, v (and O,
    dO in the backward) get zero columns up to the kernels' head dim; the
    values in front are untouched, and a head dim that fits stays as it is."""
    g = torch.Generator().manual_seed(hd)
    named = {n: torch.randn((2, 5, h, hd), generator=g).to(dtype) for n, h in (("q", 4), ("k", 2), ("v", 2))}
    out = ops.pad_head_dim(named)
    for n, x in named.items():
        assert out[n].shape == (*x.shape[:3], want) and out[n].dtype == dtype
        assert torch.equal(out[n][..., :hd], x) and not out[n][..., hd:].any()
        if want == hd:
            assert out[n] is x


def _plan(x: torch.Tensor) -> list[int]:
    return fa.tma_plan(tuple(x.shape), x.stride(), x.element_size())


def test_tma_plan_of_a_contiguous_tensor():
    """(B 2, T 300, H 16, hd 128) contiguous: strides (t) 16*128, (h) 128,
    (b) 300*16*128 elements; by stride the outer dims run h, t, b."""
    x = torch.empty((2, 300, 16, 128), dtype=torch.bfloat16)
    assert _plan(x) == [128, 16, 300, 2,                    # dims: hd, H, T, B
                        256, 4096, 1228800,                 # bytes: 128*2, 2048*2, 614400*2
                        64, 1, 64, 1,                       # box: 64 columns, 1 head, 64 rows, 1 batch row
                        2, 1, 3]                            # T, H, B at positions 2, 1, 3


def test_tma_plan_of_a_fused_projection_slice():
    """k as heads 8..9 of a (2, 300, 12, 64) projection: the slice keeps
    the projection's strides, and its base is an offset the map does not
    see."""
    fused = torch.empty((2, 300, 12, 64), dtype=torch.bfloat16)
    k = fused[:, :, 8:10]
    assert _plan(k) == [64, 2, 300, 2, 128, 12 * 64 * 2, 300 * 12 * 64 * 2, 64, 1, 64, 1, 2, 1, 3]


def test_tma_plan_of_a_transposed_tensor():
    """dO laid out (B, H, T, hd) and viewed (B, T, H, hd): t is now the
    smallest outer stride, so the map runs hd, T, H, B."""
    do = torch.empty((2, 8, 300, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert _plan(do) == [64, 300, 8, 2, 128, 300 * 64 * 2, 8 * 300 * 64 * 2, 64, 64, 1, 1, 1, 2, 3]


def test_tma_plan_of_a_batch_of_one_with_a_zero_stride():
    """B 1 broadcast with stride 0: a dim of extent 1 is never stepped, so
    the plan gives it the span of the others (300 * 16 * 128 elements) and
    keeps it last; T and H keep their strides."""
    x = torch.empty((300, 16, 128), dtype=torch.bfloat16).as_strided((1, 300, 16, 128), (0, 2048, 128, 1))
    assert _plan(x) == [128, 16, 300, 1, 256, 4096, 1228800, 64, 1, 64, 1, 2, 1, 3]


def test_bf16_broadcast_views_are_not_read_in_place():
    """TMA takes no zero stride: a bf16 view broadcast along T (as autograd
    can hand dO over) is laid out afresh before the backward, and refused
    as a forward input; fp32 views keep being read in place."""
    do = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16).expand(2, 300, 4, 64)
    assert not ops._aligned(do) and ops._aligned(do.contiguous())
    assert ops._aligned(do.float().expand(2, 300, 4, 64))
    with pytest.raises(ValueError, match="broadcast"):
        ops._check_layout("q", do)


def test_tma_plan_refuses_a_strided_last_dim():
    x = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        _plan(x)


def test_check_card_refuses_cpu_tensors():
    """The card-side checks (where the dtype-dependent padding happens)
    take CUDA tensors only; the CPU path is the plain version's."""
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops._check_card({"q": q, "k": q, "v": q})
