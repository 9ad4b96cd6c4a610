"""The port's CUDA kernels against their plain versions, on the card, with
proof that each call launched its kernel. Imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_gather import ops as t_fg, ref as t_fg_ref
from repro_torch.kernels.segment_reduce import ops as t_sr, ref as t_sr_ref


SHAPES = [(1, 8, 1), (33, 8, 1), (100, 16, 7), (512, 64, 512), (1024, 128, 300), (777, 32, 111)]


def _seg_inputs(n, d, s, sort, seed=0):
    r = np.random.default_rng(seed + n + d + s)
    vals = r.normal(size=(n, d)).astype(np.float32)
    seg = r.integers(-1, s + 2, size=(n,)).astype(np.int32)  # out-of-range on both sides
    return vals, (np.sort(seg) if sort else seg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r_rows,d,k,id_dtype", [
    (1000, 128, 4096, torch.int32), (513, 5, 700, torch.int64), (64, 3, 1, torch.int32),
])
def test_gather_kernel_matches_plain(cuda, r_rows, d, k, id_dtype):
    g = torch.Generator().manual_seed(k)
    table = torch.randn((r_rows, d), generator=g).to(cuda)
    ids = torch.randint(-2, r_rows + 2, (k,), generator=g).to(id_dtype).to(cuda)
    before = t_fg.LAUNCHES
    got = t_fg.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert t_fg.LAUNCHES == before + 1
    assert torch.equal(got, t_fg_ref.gather_rows(table, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,s", SHAPES + [(1000, 6, 50)])
@pytest.mark.parametrize("sort", [True, False])
def test_segment_sum_kernel_matches_plain(cuda, n, d, s, sort):
    vals, seg = _seg_inputs(n, d, s, sort, seed=2)
    v, sg = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    before = t_sr.LAUNCHES
    got = t_sr.segment_sum(v, sg, s, sorted_ids=sort)
    torch.cuda.synchronize()
    assert t_sr.LAUNCHES == before + 1
    want = t_sr_ref.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), s)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,d,budget", [(1, 8, 4), (512, 128, 1024), (100, 13, 150), (300, 64, 300)])
@pytest.mark.parametrize("split_dtype", [torch.int32, torch.int64])
def test_segment_sum_csr_kernel_matches_plain(cuda, n_rows, d, budget, split_dtype):
    r = np.random.default_rng(n_rows + d)
    lengths = r.integers(0, 4, size=n_rows)
    lengths[::5] = 0  # empty rows
    splits = np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget)  # a padding tail, or none
    vals = torch.from_numpy(r.normal(size=(budget, d)).astype(np.float32))
    sp = torch.from_numpy(splits).to(split_dtype)
    before = t_sr.LAUNCHES
    got = t_sr.segment_sum_csr(vals.to(cuda), sp.to(cuda))
    torch.cuda.synchronize()
    assert t_sr.LAUNCHES == before + 1
    want = t_sr_ref.segment_sum_csr(vals, sp)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    table = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError):
        t_fg.gather_rows(table.double(), torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        t_fg.gather_rows(table, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        t_sr.segment_sum(table, torch.zeros(4, dtype=torch.int64, device=cuda), 2)
    with pytest.raises(ValueError):
        t_sr.segment_sum_csr(table, torch.zeros(3, dtype=torch.float32, device=cuda))


@pytest.mark.cuda
def test_segment_mean_kernel_matches_plain(cuda):
    vals, seg = _seg_inputs(300, 16, 40, sort=True, seed=3)
    v, sg = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    before = t_sr.LAUNCHES
    got = t_sr.segment_mean(v, sg, 40, sorted_ids=True)
    torch.cuda.synchronize()
    assert t_sr.LAUNCHES == before + 2  # sums and counts
    want = t_sr_ref.segment_mean(torch.from_numpy(vals), torch.from_numpy(seg), 40)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
