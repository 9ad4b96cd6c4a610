"""The port's CUDA kernels against their plain versions, on the card, with
proof that each call launched its kernel. Imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.kernels.flash_attention import ops as t_fa, ref as t_fa_ref
from repro_torch.kernels.fused_gather import ops as t_fg, ref as t_fg_ref
from repro_torch.kernels.fused_scatter import ops as t_fs, ref as t_fs_ref
from repro_torch.kernels.fused_transform import ops as t_ft, ref as t_ft_ref
from repro_torch.kernels.segment_reduce import ops as t_sr, ref as t_sr_ref
from repro_torch.kernels.sequence_tile import ops as t_st, ref as t_st_ref
from repro_torch.launch.cells import build_cell


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


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values at an address 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# (R, D, K, id dtype, table 4 bytes off a 16-byte boundary); ids in
# [-2, R + 2): PAD and out-of-range ids both sides
@pytest.mark.cuda
@pytest.mark.parametrize("r_rows,d,k,id_dtype,unaligned", [
    (1000, 128, 4096, torch.int32, False), (513, 5, 700, torch.int64, False), (64, 3, 1, torch.int32, False),
    (5000, 8, 1001, torch.int32, False), (300, 8, 33, torch.int64, False),  # the MSE D, K not a multiple of 32
    (2000, 2048, 77, torch.int64, False), (400, 2048, 1000, torch.int32, False),  # the LM D
    (513, 5, 700, torch.int32, True), (1000, 128, 999, torch.int64, True), (100, 2048, 40, torch.int32, True),
    (20, 64, 300, torch.int64, False), (50, 16, 65, torch.int32, False), (9, 1, 100, torch.int64, False),
])
def test_gather_kernel_matches_plain(cuda, r_rows, d, k, id_dtype, unaligned):
    g = torch.Generator().manual_seed(k)
    table = torch.randn((r_rows, d), generator=g).to(cuda)
    table = _unaligned(table) if unaligned else table
    ids = torch.randint(-2, r_rows + 2, (k,), generator=g).to(id_dtype).to(cuda)
    before = t_fg.LAUNCHES
    got = t_fg.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert t_fg.LAUNCHES == before + 1
    assert torch.equal(got, t_fg_ref.gather_rows(table, ids))


# The slab gather's cases, as tests/test_torch_kernels.py holds the plain
# version to the reference on them: (name, R, D, K, ids in [lo, hi),
# rows_blk, slab, id dtype); "one_pad" has one PAD id in a run of high ids.
SLAB_CASES = [
    ("reference", 2048, 64, 512, 0, 384, 128, 512, torch.int32),
    ("straddle", 2048, 16, 200, 1000, 1300, 128, 512, torch.int32),
    ("one_pad", 2048, 32, 128, 1536, 2048, 128, 512, torch.int64),
    ("out_of_range", 1000, 16, 700, -40, 1040, 128, 512, torch.int64),
    ("small", 100, 8, 300, 0, 100, 128, 512, torch.int32),
    ("d1", 4096, 1, 1000, 0, 4096, 128, 512, torch.int64),
    ("d5", 3000, 5, 777, 0, 3000, 64, 256, torch.int32),
    ("d16_windows", 8192, 16, 2048, 0, 8192, 128, 512, torch.int64),
    ("d128", 4096, 128, 640, 0, 600, 128, 512, torch.int32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,r_rows,d,k,lo,hi,rows_blk,slab,id_dtype", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
@pytest.mark.parametrize("unaligned", [False, True])
def test_gather_slab_kernel_matches_plain(cuda, name, r_rows, d, k, lo, hi, rows_blk, slab, id_dtype,
                                          unaligned):
    """Equal to the plain version, one launch; ``unaligned`` reads the table
    through a view 4 bytes off a 16-byte boundary (the scalar path)."""
    g = torch.Generator().manual_seed(k + d)
    table = torch.randn((r_rows, d), generator=g)
    ids = torch.sort(torch.randint(lo, hi, (k,), generator=g)).values.to(id_dtype)
    if name == "one_pad":
        ids[0] = -1
    tab = table.to(cuda)
    if unaligned:
        tab = torch.zeros(table.numel() + 1, device=cuda)[1:].view(table.shape)
        tab.copy_(table)
    before = t_fg.SLAB_LAUNCHES
    got = t_fg.gather_rows(tab, ids.to(cuda), mode="slab", rows_blk=rows_blk, slab=slab)
    torch.cuda.synchronize()
    assert t_fg.SLAB_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), t_fg_ref.gather_rows_slab(table, ids, rows_blk, slab))


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
        t_fg.gather_rows(table, torch.zeros(2, dtype=torch.int32, device=cuda), mode="slab", slab=0)
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


def _launches():
    return {"add": t_fs.LAUNCHES_ADD, "set": t_fs.LAUNCHES_SET}


@pytest.mark.cuda
@pytest.mark.parametrize("r_rows,d,k,id_dtype", [
    (1000, 128, 700, torch.int32), (513, 5, 300, torch.int64), (64, 4, 1, torch.int32),
])
@pytest.mark.parametrize("op", ["add", "set"])
def test_scatter_kernel_matches_plain(cuda, r_rows, d, k, id_dtype, op):
    """Unique ids with invalid and out-of-range slots, through a view of a
    stacked table; row 0 is touched by no invalid slot. Bit-equal."""
    g = torch.Generator().manual_seed(k + d)
    stacked = torch.randn((2, r_rows, d), generator=g)
    ids = (torch.randperm(r_rows + 4, generator=g)[:k] - 2).to(id_dtype)
    ids[ids == 0] = -1  # row 0 stays a target of nothing valid
    rows = torch.randn((k, d), generator=g)
    valid = torch.rand(k, generator=g) < 0.7
    want = stacked[1].clone()
    (t_fs_ref.scatter_add_rows if op == "add" else t_fs_ref.scatter_set_rows)(want, ids, rows, valid)
    dev = stacked.to(cuda)
    fn = t_fs.scatter_add_rows if op == "add" else t_fs.scatter_set_rows
    before = _launches()
    got = fn(dev[1], ids.to(cuda), rows.to(cuda), valid.to(cuda))
    torch.cuda.synchronize()
    assert _launches()[op] == before[op] + 1
    assert got.data_ptr() == dev[1].data_ptr()
    assert torch.equal(dev[1].cpu(), want)
    assert torch.equal(dev[0].cpu(), stacked[0]) and torch.equal(dev[1, 0].cpu(), stacked[1, 0])


@pytest.mark.cuda
def test_scatter_kernel_without_valid_and_with_no_slots(cuda):
    table = torch.randn((50, 12), device=cuda)
    ids = torch.tensor([3, 7, 49, 60, -1], device=cuda)
    rows = torch.randn((5, 12), device=cuda)
    want = t_fs_ref.scatter_add_rows(table.clone(), ids, rows)
    before = _launches()
    t_fs.scatter_add_rows(table, ids, rows)
    t_fs.scatter_set_rows(table, ids[:0], rows[:0])  # nothing to do: no launch
    torch.cuda.synchronize()
    assert _launches() == {"add": before["add"] + 1, "set": before["set"]}
    assert torch.equal(table, want)


# The scatter's cases: (R, D, K, share of valid slots, with a valid mask,
# id dtype, table view 4 bytes off a 16-byte boundary). D 8 (the MSE step),
# 13 (the scalar path), 128 (dlrm), 2,048 (qwen2.5-3b); 90% and all slots
# invalid; no mask; K not a multiple of 32.
SCATTER_CASES = [
    (5000, 8, 4096, 0.35, True, torch.int32, False), (700, 13, 333, 0.7, True, torch.int64, False),
    (40_000, 128, 30_017, 0.1, True, torch.int64, False), (3000, 2048, 1000, 0.5, True, torch.int32, False),
    (2000, 128, 1000, 0.0, True, torch.int32, False), (900, 16, 777, 1.0, False, torch.int64, False),
    (4000, 64, 3001, 0.7, True, torch.int32, True), (100, 8, 31, 0.9, True, torch.int64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r_rows,d,k,share,with_valid,id_dtype,unaligned", SCATTER_CASES)
@pytest.mark.parametrize("op", ["add", "set"])
def test_scatter_kernel_cases_match_plain(cuda, r_rows, d, k, share, with_valid, id_dtype, unaligned, op):
    """Unique ids, some out of range, through a view of a stacked table
    (``unaligned``: a table 4 bytes off a 16-byte boundary, the scalar
    path): bit-equal to the plain version, one launch, the other table
    untouched."""
    g = torch.Generator().manual_seed(r_rows + d + k)
    buf = torch.randn((2 * r_rows * d + 1,), generator=g)
    stacked = (buf[1:] if unaligned else buf[:-1]).view(2, r_rows, d)
    ids = (torch.randperm(r_rows + 4, generator=g)[:k] - 2).to(id_dtype)
    rows = torch.randn((k, d), generator=g)
    valid = torch.rand(k, generator=g) < share if with_valid else None
    want = stacked[1].clone()
    (t_fs_ref.scatter_add_rows if op == "add" else t_fs_ref.scatter_set_rows)(want, ids, rows, valid)
    dev_buf = buf.to(cuda)
    dev = (dev_buf[1:] if unaligned else dev_buf[:-1]).view(2, r_rows, d)
    assert (dev[1].data_ptr() % 16 != 0) == unaligned
    fn = t_fs.scatter_add_rows if op == "add" else t_fs.scatter_set_rows
    before = _launches()
    fn(dev[1], ids.to(cuda), rows.to(cuda), None if valid is None else valid.to(cuda))
    torch.cuda.synchronize()
    assert _launches()[op] == before[op] + 1
    assert torch.equal(dev[1].cpu(), want) and torch.equal(dev[0].cpu(), stacked[0])


def _group_case(n_feat, d, split_dtype, seed):
    """A dim group's rows: n_feat sum features (the third every row empty),
    a non-sum feature's rows before the second and the last, padding tails."""
    r = np.random.default_rng(seed)
    offsets, splits, sizes, ofs = [], [], [], 0
    for f in range(n_feat):
        if f in (1, n_feat - 1) and n_feat > 1:
            ofs += 17
        n_rows, budget = int(r.integers(1, 300)), int(r.integers(300, 900))
        lengths = r.integers(0, 4, size=n_rows)
        lengths[::5] = 0
        if f == 2:
            lengths[:] = 0
        sp = np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget - 1)
        splits.append(torch.from_numpy(sp).to(split_dtype))
        offsets.append(ofs)
        sizes.append(budget)
        ofs += budget
    vals = torch.from_numpy(r.normal(size=(ofs + 5, d)).astype(np.float32))
    return vals, splits, offsets, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("n_feat", [1, 26, 61, 70])
@pytest.mark.parametrize("d", [8, 13, 128])
@pytest.mark.parametrize("split_dtype", [torch.int32, torch.int64])
def test_segment_sum_csr_group_kernels_match_plain(cuda, n_feat, d, split_dtype):
    """The grouped forward within 1e-5 of its plain version and bit-equal to
    the per-feature kernel on each slice; its backward (a strided gradient,
    a missing one) bit-equal to the plain version. One launch each way per
    group of up to 64 features (two for 70)."""
    vals, splits, offsets, sizes = _group_case(n_feat, d, split_dtype, seed=n_feat + d)
    want = t_sr_ref.segment_sum_csr_group(vals, splits, offsets, sizes)
    v = vals.to(cuda).requires_grad_()
    sp = [x.to(cuda) for x in splits]
    launches = -(-n_feat // 64)
    before = (t_sr.GROUP_LAUNCHES, t_sr.GROUP_LAUNCHES_BWD)
    outs = t_sr.segment_sum_csr_group(v, sp, offsets, sizes)
    torch.cuda.synchronize()
    assert t_sr.GROUP_LAUNCHES == before[0] + launches
    for o, w, x, ofs, n in zip(outs, want, sp, offsets, sizes):
        np.testing.assert_allclose(o.detach().cpu().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(o.detach(), t_sr.segment_sum_csr(v.detach()[ofs:ofs + n], x))
    r = np.random.default_rng(d)
    grads = [torch.from_numpy(r.normal(size=(x.shape[0] - 1, 3, d)).astype(np.float32)).to(cuda)[:, 1]
             if f == 0 else None if f == n_feat - 1 and n_feat > 1
             else torch.from_numpy(r.normal(size=(x.shape[0] - 1, d)).astype(np.float32)).to(cuda)
             for f, x in enumerate(splits)]
    assert grads[0].stride(0) == 3 * d  # read in place, as dlrm's stacked gradient columns
    want_g = t_sr_ref.segment_expand_csr_group([None if x is None else x.cpu() for x in grads], splits,
                                               offsets, sizes, vals.shape[0], d)
    used = [f for f, x in enumerate(grads) if x is not None]
    (got_g,) = torch.autograd.grad([outs[f] for f in used], v, [grads[f] for f in used])
    torch.cuda.synchronize()
    assert t_sr.GROUP_LAUNCHES_BWD == before[1] + launches
    assert torch.equal(got_g.cpu(), want_g)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,d,budget", [(1, 8, 4), (512, 128, 1024), (100, 13, 150), (300, 64, 300)])
@pytest.mark.parametrize("split_dtype", [torch.int32, torch.int64])
def test_segment_sum_csr_backward_kernel_matches_plain(cuda, n_rows, d, budget, split_dtype):
    """The gradient through autograd, and through a strided gradient: a copy,
    so bit-equal, with zeros for empty rows and the padding tail."""
    r = np.random.default_rng(n_rows + d + 7)
    lengths = r.integers(0, 4, size=n_rows)
    lengths[::5] = 0
    splits = torch.from_numpy(np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget)).to(split_dtype)
    gr = torch.from_numpy(r.normal(size=(n_rows, d)).astype(np.float32))
    want = t_sr_ref.segment_expand_csr(gr, splits, budget)
    vals = torch.from_numpy(r.normal(size=(budget, d)).astype(np.float32)).to(cuda).requires_grad_()
    before = t_sr.LAUNCHES_BWD
    out = t_sr.segment_sum_csr(vals, splits.to(cuda))
    (got,) = torch.autograd.grad(out, vals, gr.to(cuda))
    wide = torch.zeros((n_rows, 3, d), device=cuda)
    wide[:, 2] = gr.to(cuda)
    strided = t_sr.segment_expand_csr(wide[:, 2], splits.to(cuda), budget)
    torch.cuda.synchronize()
    assert t_sr.LAUNCHES_BWD == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(strided.cpu(), want)


@pytest.mark.cuda
def test_bucketize_on_the_card_runs_its_kernel(cuda):
    """The Feature Engine's bucketize group on the card: one fused_transform
    launch for both columns, the ids equal to the CPU's."""
    specs = [FeatureSpec("q", transform="bucketize", emb_dim=4, boundaries=(0.0, 1.0)),
             FeatureSpec("p", transform="bucketize", emb_dim=4, boundaries=(-2.0, -1.0, 3.0))]
    g = torch.Generator().manual_seed(3)
    batch = {s.name: Ragged(torch.randn(6, generator=g) * 2, torch.tensor([0, 2, 5], dtype=torch.int32))
             for s in specs}
    want, _ = FeatureEngine(specs, "cpu").apply(batch)
    before = t_ft.LAUNCHES
    got, _ = FeatureEngine(specs, cuda).apply(
        {k: Ragged(r.values.to(cuda), r.row_splits.to(cuda)) for k, r in batch.items()})
    torch.cuda.synchronize()
    assert t_ft.LAUNCHES == before + 1
    for k in want:
        assert torch.equal(got[k].values.cpu(), want[k].values)


def _bucket_case(r, widths, n, dtype=np.float32, layout="random"):
    """Sorted boundaries per column; values random, on every boundary, one
    float step either side of it, ±inf, NaN, ±0.0 and subnormals. Column
    ids random in [0, C) ("random"), each column's values one contiguous
    run as the engine lays them out ("contiguous"), or random in
    [-(C+3), C+3) ("out_of_range")."""
    bnds = np.concatenate([np.sort(r.normal(size=w)).astype(np.float32) for w in widths])
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    vals = r.normal(size=n).astype(np.float32)
    on = bnds[r.integers(0, bnds.size, n // 4)]
    m = on.size
    vals[:m] = on
    vals[m:2 * m] = np.nextafter(on, np.float32(np.inf))
    vals[2 * m:3 * m] = np.nextafter(on, np.float32(-np.inf))
    special = [np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45, 1e-39, -3e-39]
    vals[n - min(n, 9):] = special[:min(n, 9)]
    c = len(widths)
    if layout == "contiguous":
        cids = np.repeat(np.arange(c, dtype=np.int32), -(-n // c))[:n]
    elif layout == "out_of_range":
        cids = r.integers(-(c + 3), c + 3, n).astype(np.int32)
    else:
        cids = r.integers(0, c, n).astype(np.int32)
    return vals.astype(dtype), cids, bnds, offs


_OP_WIDTHS = [int(w) for w in np.random.default_rng(1).integers(8, 64, 100)]  # the operator benchmark's


# (column widths, N, value type, column-id layout, values 4 bytes off a
# 16-byte boundary, the paths its blocks take: staged where the table or a
# tile's columns fit a block's 1,024 words of shared memory, as the
# engine's contiguous columns do, else cached)
@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,dtype,layout,unaligned,paths", [
    ([17] * 20, 2_560, np.float32, "random", False, {"staged"}),       # 361 words: the whole table
    ([1], 1_000, np.float32, "random", False, {"staged"}),
    ([1_000, 17, 1], 4_097, np.float32, "random", False, {"staged"}),   # 1,022 words
    ([3_000] * 5, 70_001, np.float32, "random", False, {"cached"}),     # a table over 48 KB
    ([8, 63, 40] * 33 + [9], 200_000, np.float32, "random", False, {"cached"}),
    ([17] * 20, 5_003, np.float64, "random", False, {"staged"}),
    ([17] * 20, 1_310_720, np.float32, "contiguous", False, {"staged"}),  # the MSE step
    (_OP_WIDTHS, 200_000, np.float32, "contiguous", False, {"staged"}),   # the operator shape
    ([150] * 100, 100_003, np.float32, "random", False, {"cached"}),      # random ids over 60 KB
    ([3_000] * 5, 65_536, np.float32, "contiguous", False, {"cached"}),   # contiguous columns over 48 KB
    ([600, 900, 5, 3_000], 20_000, np.float32, "contiguous", False, {"staged", "cached"}),
    ([17] * 20, 3, np.float32, "random", False, {"staged"}),              # N < 4
    ([17] * 20, 270_341, np.float32, "contiguous", False, {"staged"}),    # N % 4 = 1, two chunks a thread
    ([17] * 20, 5_003, np.float32, "contiguous", True, {"staged"}),
    (_OP_WIDTHS, 300_007, np.float32, "random", True, {"cached"}),
    ([17] * 20, 20_000, np.float32, "out_of_range", False, {"staged"}),
    ([3_000] * 5, 20_000, np.float32, "out_of_range", False, {"cached"}),
    ([0, 5, 0, 17, 0], 10_000, np.float32, "out_of_range", False, {"staged"}),  # width-0 columns
])
def test_bucketize_kernel_matches_plain(cuda, widths, n, dtype, layout, unaligned, paths):
    """Exact, at column widths 0 to 3,000, N from 3 up, N not a multiple of
    4 or of the block, a table too large for shared memory, the MSE step's
    and the operator benchmark's shapes, out-of-range column ids, values at
    an unaligned address and fp64 input; each launch counted, on the paths
    the launcher's plan gives its blocks, and two launches bit-equal."""
    from repro_torch.kernels.fused_transform import fused_transform as t_ft_launch

    r = np.random.default_rng(n)
    vals, cids, bnds, offs = _bucket_case(r, widths, n, dtype, layout)
    assert t_ft_launch.launch_paths(cids, offs, torch.cuda.get_device_properties(cuda).multi_processor_count) == paths
    args = [torch.from_numpy(x).to(cuda) for x in (vals, cids, bnds, offs)]
    if unaligned:
        args[0] = _unaligned(args[0])
    before, ran = t_ft.LAUNCHES, t_ft_launch.path_launches()
    got = t_ft.fused_bucketize(*args)
    again = t_ft.fused_bucketize(*args)
    torch.cuda.synchronize()
    after = t_ft_launch.path_launches()
    assert t_ft.LAUNCHES == before + 2
    for which, name in enumerate(t_ft_launch.PATHS):
        assert after[which] == ran[which] + (2 if name in paths else 0)
    want = t_ft_ref.fused_bucketize(*args)
    assert got.dtype == torch.int64 and torch.equal(got, want) and torch.equal(again, got)


def _tile_case(r, n_rows, d, split_dtype, tail=9):
    lens = r.integers(0, 12, n_rows)
    lens[::5] = 0      # empty rows
    lens[1] = 60       # a row longer than any k
    budget = int(lens.sum()) + tail  # a padding tail
    splits = np.concatenate([[0], np.cumsum(lens)]).astype(split_dtype)
    return torch.from_numpy(r.normal(size=(budget, d)).astype(np.float32)), torch.from_numpy(splits)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 13, 50, 128])
@pytest.mark.parametrize("k", [1, 8, 50])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_sequence_tile_and_untile_kernels_match_plain(cuda, d, k, split_dtype):
    r = np.random.default_rng(d * k)
    vals, splits = _tile_case(r, 97, d, split_dtype)
    g = torch.from_numpy(r.normal(size=(97, k, d)).astype(np.float32))
    before = (t_st.LAUNCHES, t_st.BWD_LAUNCHES)
    got = t_st.sequence_tile(vals.to(cuda), splits.to(cuda), k)
    got_g = t_st.sequence_untile(g.to(cuda), splits.to(cuda), vals.shape[0])
    torch.cuda.synchronize()
    assert (t_st.LAUNCHES, t_st.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got.cpu(), t_st_ref.sequence_tile(vals, splits, k))
    assert torch.equal(got_g.cpu(), t_st_ref.sequence_untile(g, splits, vals.shape[0]))


# The untile's edge cases: rows of length k - 1, k and 10k, empty rows
# (every fifth), the first split past 0 (a head of zeros), a padding tail
def _untile_case(r, k, d, split_dtype, head, tail=9, n_rows=70):
    lens = r.integers(0, 2 * k + 2, n_rows)
    lens[::5] = 0
    lens[1:4] = k - 1, k, 10 * k
    splits = (head + np.concatenate([[0], np.cumsum(lens)])).astype(split_dtype)
    n = int(splits[-1]) + tail
    g = torch.from_numpy(r.normal(size=(n_rows, k, d)).astype(np.float32))
    return g, torch.from_numpy(splits), n


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 13, 128])
@pytest.mark.parametrize("k", [1, 8, 50])
@pytest.mark.parametrize("head", [0, 5])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_sequence_untile_kernel_edge_cases_match_plain(cuda, d, k, head, split_dtype):
    g, splits, n = _untile_case(np.random.default_rng(d + k + head), k, d, split_dtype, head)
    gc = _unaligned(g.to(cuda)) if head and d == 128 else g.to(cuda)  # and an unaligned view: the scalar path
    before = t_st.BWD_LAUNCHES
    got = t_st.sequence_untile(gc, splits.to(cuda), n)
    torch.cuda.synchronize()
    assert t_st.BWD_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), t_st_ref.sequence_untile(g, splits, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,head,tail", [(0, 3, 10), (40, 2, 5)])
def test_sequence_untile_kernel_without_rows_or_values(cuda, n_rows, head, tail):
    """No rows at all, and rows that are all empty: every position zero."""
    g = torch.randn((n_rows, 4, 8), generator=torch.Generator().manual_seed(n_rows))
    splits = torch.full((n_rows + 1,), head, dtype=torch.int32)
    before = t_st.BWD_LAUNCHES
    got = t_st.sequence_untile(g.to(cuda), splits.to(cuda), head + tail)
    torch.cuda.synchronize()
    assert t_st.BWD_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), torch.zeros((head + tail, 8)))


@pytest.mark.cuda
def test_gather_and_untile_launch_on_the_current_stream(cuda):
    """Inside ``torch.cuda.stream(side)`` both kernels run on ``side``: their
    inputs are written there behind a long sleep, so a kernel on any other
    stream would read them before they are written."""
    r = np.random.default_rng(3)
    src_table = torch.from_numpy(r.normal(size=(4000, 128)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(r.integers(-1, 4000, 20_000)).to(cuda)
    g_src, splits, n = _untile_case(r, 8, 8, np.int32, head=4, n_rows=5000)
    g_src, splits = g_src.to(cuda), splits.to(cuda)
    table, g = torch.zeros_like(src_table), torch.zeros_like(g_src)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = (t_fg.LAUNCHES, t_st.BWD_LAUNCHES)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # about 0.1 s at the H100's clock
        table.copy_(src_table)
        g.copy_(g_src)
        got = t_fg.gather_rows(table, ids)
        got_g = t_st.sequence_untile(g, splits, n)
    side.synchronize()
    assert (t_fg.LAUNCHES, t_st.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, t_fg_ref.gather_rows(src_table, ids))
    assert torch.equal(got_g, t_st_ref.sequence_untile(g_src, splits, n))


@pytest.mark.cuda
def test_sequence_tile_autograd_runs_both_kernels(cuda):
    r = np.random.default_rng(5)
    vals, splits = _tile_case(r, 64, 8, np.int32)
    v = vals.to(cuda).requires_grad_()
    before = (t_st.LAUNCHES, t_st.BWD_LAUNCHES)
    out = t_st.sequence_tile(v, splits.to(cuda), 8)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (dv,) = torch.autograd.grad(out, v, g.to(cuda))
    torch.cuda.synchronize()
    assert (t_st.LAUNCHES, t_st.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(dv.cpu(), t_st_ref.sequence_untile(g.view(64, 8, 8), splits, vals.shape[0]))


@pytest.mark.cuda
def test_smoke_mse_train_card_matches_cpu(cuda):
    """Three steps of the MSE example's cell (its own constants) on the card
    and on the CPU from one state, on the same batches: the overflow counters
    and the IDMap equal, the loss within 2e-2 (bf16 logits), rows within
    2 * 1e-2 * 3 and dense params within 2 * 1e-3 * 3 (Adam's sign flips,
    as in tests/test_torch_mse.py); one bucketize, four tile and four untile
    launches and one grouped segment sum each way a step (the dim-8 group's
    61 sum features in one launch)."""
    from repro_torch.examples import train_mse as mse

    cells = {d: mse.MSECell(d) for d in ("cpu", cuda)}
    states = {d: c.init_state() for d, c in cells.items()}
    states[cuda]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    for s in range(3):
        arrays = mse.batch_arrays(cells["cpu"].specs, mse.BATCH, seed=s)
        before = (t_ft.LAUNCHES, t_st.LAUNCHES, t_st.BWD_LAUNCHES, t_sr.GROUP_LAUNCHES,
                  t_sr.GROUP_LAUNCHES_BWD, t_sr.LAUNCHES, t_sr.LAUNCHES_BWD)
        outs = {}
        for d, c in cells.items():
            states[d], outs[d] = c.step_fn(states[d], mse.to_batch(arrays, d))
        torch.cuda.synchronize()
        now = (t_ft.LAUNCHES, t_st.LAUNCHES, t_st.BWD_LAUNCHES, t_sr.GROUP_LAUNCHES,
               t_sr.GROUP_LAUNCHES_BWD, t_sr.LAUNCHES, t_sr.LAUNCHES_BWD)
        assert tuple(b - a for a, b in zip(before, now)) == (1, 4, 4, 1, 1, 0, 0)
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        assert met[cuda] == met["cpu"]
        np.testing.assert_allclose(float(outs[cuda]["loss"]), float(outs["cpu"]["loss"]), atol=2e-2)
    sp = {d: st["sparse"]["dim8"] for d, st in states.items()}
    for f in ("keys", "occupied", "offsets", "last_use", "free_stack", "free_size", "next_row"):
        assert torch.equal(getattr(sp[cuda]["idmap"], f).cpu(), getattr(sp["cpu"]["idmap"], f)), f
    np.testing.assert_allclose(sp[cuda]["blocks"].emb.cpu().numpy(), sp["cpu"]["blocks"].emb.numpy(),
                               rtol=0, atol=2 * 1e-2 * 3)
    for n, p in states["cpu"]["dense"].state_dict().items():
        np.testing.assert_allclose(states[cuda]["dense"].state_dict()[n].cpu().numpy(), p.numpy(),
                                   rtol=0, atol=2 * 1e-3 * 3, err_msg=n)


@pytest.mark.cuda
def test_smoke_train_cell_card_matches_cpu(cuda):
    """Three train steps from one state on the same batches: integers equal,
    floats within the bf16 tolerances of tests/test_torch_train.py (lr 1e-3,
    3 steps: params and rows within 2 * lr * 3)."""
    shape = ShapeCell("train_batch", "train", {"batch": 32})
    cells = {d: build_cell("dlrm-mlperf", "train_batch", smoke=True, shape_override=shape, device=d)
             for d in ("cpu", "cuda")}
    states = {d: c.init_state() for d, c in cells.items()}
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    counts = (t_fg.LAUNCHES, t_sr.GROUP_LAUNCHES, t_sr.GROUP_LAUNCHES_BWD, t_fs.LAUNCHES_ADD, t_fs.LAUNCHES_SET)
    for s in range(3):
        outs = {}
        for d, c in cells.items():
            states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        assert met["cuda"] == met["cpu"]
        np.testing.assert_allclose(float(outs["cuda"]["loss"]), float(outs["cpu"]["loss"]), atol=2e-2)
    now = (t_fg.LAUNCHES, t_sr.GROUP_LAUNCHES, t_sr.GROUP_LAUNCHES_BWD, t_fs.LAUNCHES_ADD, t_fs.LAUNCHES_SET)
    assert all(b > a for a, b in zip(counts, now))
    rows = {d: c.engine.export_rows(states[d]["sparse"])["dim16"] for d, c in cells.items()}
    np.testing.assert_array_equal(rows["cuda"]["ids"], rows["cpu"]["ids"])
    np.testing.assert_allclose(rows["cuda"]["emb"], rows["cpu"]["emb"], rtol=0, atol=6e-3)
    for n, p in states["cpu"]["dense"].state_dict().items():
        np.testing.assert_allclose(states["cuda"]["dense"].state_dict()[n].cpu().numpy(), p.numpy(),
                                   rtol=0, atol=6e-3, err_msg=n)


# flash attention forward: the kernel against its plain version on the card.
# Both keep fp32 statistics and round O once, so O may differ by one rounding:
# |got - want| <= rtol * |want| + atol * max|want|, with rtol 1e-2 in bf16 (one
# bf16 ulp is at most 2^-7 of the value) and 1e-4 in fp32 (summation order),
# atol 1e-3 in bf16 and 1e-4 in fp32. A zero output reads max|want| and fails.
# LSE within 1e-4.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
FLASH_CASES = [  # B, T, H, Hk, hd, dtype, causal
    (1, 128, 2, 2, 64, torch.float32, True), (2, 200, 4, 2, 16, torch.float32, True),
    (1, 1024, 8, 1, 128, torch.bfloat16, True), (2, 1024, 16, 2, 128, torch.bfloat16, True),
    (1, 200, 8, 8, 32, torch.bfloat16, True), (2, 128, 4, 4, 128, torch.float32, True),
    (1, 1024, 4, 2, 64, torch.bfloat16, True), (1, 200, 2, 1, 128, torch.float32, True),
    (2, 200, 4, 2, 64, torch.float32, False), (1, 1024, 2, 1, 16, torch.bfloat16, False),
    # head dims the kernels take padded to the next of 16, 32, 64, 128
    (1, 200, 4, 2, 8, torch.float32, True), (2, 128, 2, 1, 8, torch.bfloat16, True),
    (1, 300, 4, 4, 48, torch.float32, True), (1, 1024, 4, 2, 48, torch.bfloat16, False),
    # the bf16 tensor-core kernels' edges: T below, at and either side of a
    # 64-row TMA box and at the train length, qwen2.5-3b's heads (G = 8);
    # a full (non-causal) hd-128 case; G = 8 at hd 64
    (1, 64, 16, 2, 128, torch.bfloat16, True), (1, 127, 16, 2, 128, torch.bfloat16, True),
    (1, 129, 16, 2, 128, torch.bfloat16, True), (1, 4096, 16, 2, 128, torch.bfloat16, True),
    (2, 300, 8, 2, 128, torch.bfloat16, False), (2, 256, 8, 1, 64, torch.bfloat16, True),
]


def _flash_inputs(b, t, h, hk, hd, dtype, cuda, seed=0):
    g = torch.Generator().manual_seed(seed + b * t + h * hk + hd)
    return [torch.randn((b, t, n, hd), generator=g).to(dtype).to(cuda) for n in (h, hk, hk)]


def _check_flash(q, k, v, causal):
    before = t_fa.LAUNCHES
    o, lse = t_fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert t_fa.LAUNCHES == before + 1
    want_o, want_lse = t_fa_ref.flash_fwd(q, k, v, causal)
    rtol, atol = FLASH_TOL[q.dtype]
    assert o.dtype == q.dtype and o.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    want = want_o.float().cpu().numpy()
    np.testing.assert_allclose(o.float().cpu().numpy(), want, rtol=rtol, atol=atol * np.abs(want).max())
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hk,hd,dtype,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, monkeypatch, b, t, h, hk, hd, dtype, causal):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # a full-fp32 oracle
    _check_flash(*_flash_inputs(b, t, h, hk, hd, dtype, cuda), causal)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_and_unaligned_inputs(cuda, monkeypatch):
    """q, k, v as head slices of one fused projection are read by stride;
    q at an address 4 bytes off a 16-byte boundary is refused."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, t, h, hk, hd = 2, 300, 8, 2, 64
    g = torch.Generator().manual_seed(1)
    fused = torch.randn((b, t, h + 2 * hk, hd), generator=g).to(cuda)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + hk], fused[:, :, h + hk:]
    assert not q.is_contiguous()
    _check_flash(q, k, v, True)
    buf = torch.randn(b * t * h * hd + 1, generator=g).to(cuda)
    before = t_fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        t_fa.flash_fwd(buf[1:].view(b, t, h, hd), k.contiguous(), v.contiguous())
    assert t_fa.LAUNCHES == before


@pytest.mark.cuda
def test_flash_kernel_refuses_gradients_and_bad_inputs(cuda, monkeypatch):
    """An input that needs a gradient runs the backward kernel, also for
    the zero-stride dO of a plain sum; bad inputs raise."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _flash_inputs(1, 64, 2, 1, 32, torch.float32, cuda)
    before = t_fa.BWD_LAUNCHES
    qg = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(t_fa.flash_attention(qg, k, v).sum(), qg)
    torch.cuda.synchronize()
    assert t_fa.BWD_LAUNCHES == before + 1
    o, lse = t_fa_ref.flash_fwd(q, k, v)
    want = t_fa_ref.flash_bwd(q, k, v, o, lse, torch.ones_like(q))[0]
    _close_flash(dq, want)
    with torch.no_grad():
        t_fa.flash_attention(q, k, v)  # no gradient wanted: the forward kernel runs
    with pytest.raises(ValueError):
        t_fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # head dims above 128 are refused
        t_fa.flash_attention(*_flash_inputs(1, 64, 2, 1, 192, torch.float32, cuda))
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        t_fa.flash_attention(q[:, :, :1], k.expand(1, 64, 2, 32), v)  # H not a multiple of Hk
    with pytest.raises(ValueError):
        t_fa.flash_bwd(q, k, v, o, lse[..., :32], torch.ones_like(q))  # LSE of another length


def _close_flash(got, want):
    """Within one rounding, as the forward (FLASH_TOL)."""
    rtol, atol = FLASH_TOL[want.dtype]
    w = want.float().cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), w, rtol=rtol, atol=atol * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hk,hd,dtype,causal", FLASH_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, monkeypatch, b, t, h, hk, hd, dtype, causal):
    """dQ, dK and dV of the kernel against ``ref.flash_bwd`` on the same
    inputs, O and LSE: within one rounding (FLASH_TOL), one launch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _flash_inputs(b, t, h, hk, hd, dtype, cuda)
    do = _flash_inputs(b, t, h, hk, hd, dtype, cuda, seed=1)[0]
    o, lse = t_fa.flash_fwd(q, k, v, causal)
    before = t_fa.BWD_LAUNCHES
    got = t_fa.flash_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert t_fa.BWD_LAUNCHES == before + 1
    for g, w in zip(got, t_fa_ref.flash_bwd(q, k, v, o, lse, do, causal)):
        _close_flash(g, w)


@pytest.mark.cuda
def test_flash_bwd_kernel_reads_strided_inputs(cuda, monkeypatch):
    """q, k, v as head slices of one fused projection, and a dO with
    strides of its own, are read in place."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, t, h, hk, hd = 2, 300, 8, 2, 64
    g = torch.Generator().manual_seed(2)
    fused = torch.randn((b, t, h + 2 * hk, hd), generator=g).to(cuda)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + hk], fused[:, :, h + hk:]
    do = torch.randn((b, h, t, hd), generator=g).to(cuda).transpose(1, 2)
    assert not do.is_contiguous()
    o, lse = t_fa.flash_fwd(q, k, v)
    got = t_fa.flash_bwd(q, k, v, o, lse, do)
    for g_, w in zip(got, t_fa_ref.flash_bwd(q, k, v, o, lse, do)):
        _close_flash(g_, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,causal", [(128, True), (64, False), (32, True)])
def test_flash_bf16_kernels_repeat_bit_for_bit(cuda, hd, causal):
    """Two launches of the tensor-core forward and backward on the same
    inputs give bit-equal O, LSE, dQ, dK and dV: no atomics, fixed sums."""
    q, k, v = _flash_inputs(1, 300, 16, 2, hd, torch.bfloat16, cuda)
    do = _flash_inputs(1, 300, 16, 2, hd, torch.bfloat16, cuda, seed=1)[0]
    (o1, l1), (o2, l2) = t_fa.flash_fwd(q, k, v, causal), t_fa.flash_fwd(q, k, v, causal)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    g1, g2 = (t_fa.flash_bwd(q, k, v, o1, l1, do, causal) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
def test_flash_bf16_takes_the_tensor_core_kernels(cuda):
    """A bf16 input launches the tensor-core forward and backward (the C
    side counts them); an fp32 input launches neither."""
    q, k, v = _flash_inputs(1, 128, 4, 2, 64, torch.bfloat16, cuda)
    before = t_fa.tensor_core_launches()
    o, lse = t_fa.flash_fwd(q, k, v)
    t_fa.flash_bwd(q, k, v, o, lse, torch.ones_like(q))
    assert t_fa.tensor_core_launches() == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (x.float() for x in (q, k, v))
    before = t_fa.tensor_core_launches()
    o, lse = t_fa.flash_fwd(qf, kf, vf)
    t_fa.flash_bwd(qf, kf, vf, o, lse, torch.ones_like(qf))
    torch.cuda.synchronize()
    assert t_fa.tensor_core_launches() == before


@pytest.mark.cuda
def test_flash_bwd_bf16_reads_strided_inputs(cuda):
    """The bf16 kernels read q, k, v as head slices of one fused projection
    and a transposed dO through their TMA maps."""
    b, t, h, hk, hd = 2, 300, 8, 2, 128
    g = torch.Generator().manual_seed(3)
    fused = torch.randn((b, t, h + 2 * hk, hd), generator=g).to(torch.bfloat16).to(cuda)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + hk], fused[:, :, h + hk:]
    do = torch.randn((b, h, t, hd), generator=g).to(torch.bfloat16).to(cuda).transpose(1, 2)
    _check_flash(q, k, v, True)
    o, lse = t_fa.flash_fwd(q, k, v)
    for g_, w in zip(t_fa.flash_bwd(q, k, v, o, lse, do), t_fa_ref.flash_bwd(q, k, v, o, lse, do)):
        _close_flash(g_, w)


@pytest.mark.cuda
def test_flash_bf16_backward_takes_a_broadcast_do(cuda):
    """A dO broadcast along T (stride 0, which TMA cannot map) is laid out
    afresh by the op's backward, and the gradients match the plain ones."""
    q, k, v = _flash_inputs(1, 256, 4, 2, 64, torch.bfloat16, cuda)
    do = _flash_inputs(1, 1, 4, 2, 64, torch.bfloat16, cuda, seed=2)[0].expand(1, 256, 4, 64)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(t_fa.flash_attention(qg, kg, vg), (qg, kg, vg), grad_outputs=do)
    o, lse = t_fa_ref.flash_fwd(q, k, v)
    for g_, w in zip(got, t_fa_ref.flash_bwd(q, k, v, o, lse, do.contiguous())):
        _close_flash(g_, w)


@pytest.mark.cuda
def test_checkpointed_layer_gradients_match_plain(cuda):
    """One smoke transformer layer under torch.utils.checkpoint on the card
    gives the gradients of the plain call: the recompute runs the same
    kernels on the same inputs."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import MIXED

    cfg = get_config("qwen2.5-3b", smoke=True).model
    layer = tfm.Layer(cfg, torch.Generator().manual_seed(0), cuda)
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 256, cfg.d_model), generator=g).to(cuda).to(torch.bfloat16)
    w = torch.randn((2, 256, cfg.d_model), generator=g).to(cuda)
    pos = torch.arange(256, dtype=torch.int32, device=cuda).expand(2, 256)
    grads = {}
    for remat in (True, False):
        x = x0.clone().requires_grad_()
        before = (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES)
        if remat:
            y = checkpoint(lambda x: layer(x, pos, MIXED)[0], x, use_reentrant=False)
        else:
            y = layer(x, pos, MIXED)[0]
        grads[remat] = torch.autograd.grad((y.float() * w).sum(), [x, *layer.parameters()])
        torch.cuda.synchronize()
        assert (t_fa.LAUNCHES - before[0], t_fa.BWD_LAUNCHES - before[1]) == (2 if remat else 1, 1)
    for a, b in zip(grads[True], grads[False]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
def test_smoke_prefill_cell_card_matches_cpu(cuda):
    """The qwen2.5 smoke prefill (T = 256, B = 2) on the card and on the CPU
    from the same rows and weights: metrics equal, logits and cache within
    bf16 tolerances (the stack runs in bf16 on both; sums are taken in
    another order), one flash launch per layer."""
    shape = ShapeCell("prefill_32k", "prefill", {"seq_len": 256, "global_batch": 2})
    cells = {d: build_cell("qwen2.5-3b", "prefill_32k", smoke=True, shape_override=shape, device=d)
             for d in ("cpu", "cuda")}
    cfg = cells["cpu"].arch.model
    vocab = torch.arange(cfg.vocab_size, dtype=torch.int64)
    ids = cells["cpu"].engine.engine_ids(
        {"tokens": Ragged(vocab, torch.tensor([0, cfg.vocab_size], dtype=torch.int32))})["dim64"]
    ids = ids[torch.arange(ids.numel()) % 7 != 0]  # some tokens read zero rows
    n = ids.numel()
    r = np.random.default_rng(0)
    rows = {"dim64": {"ids": ids.numpy(), "emb": r.normal(size=(n, 64)).astype(np.float32),
                      "slots": {k: np.zeros((n, 64), np.float32) for k in ("m", "v")},
                      "last_use": np.ones(n, np.int32)}}
    states = {}
    for d, c in cells.items():
        states[d] = c.init_state()
        states[d]["sparse"] = c.engine.import_rows(rows)
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    for s in range(2):
        before = t_fa.LAUNCHES
        outs = {d: c.step_fn(states[d], c.make_batch(s)) for d, c in cells.items()}
        assert t_fa.LAUNCHES == before + cfg.n_layers
        met = {d: {k: int(v) for k, v in o.items() if "/" in k} for d, o in outs.items()}
        assert met["cuda"] == met["cpu"] and met["cpu"]["dim64/dev_rows_live"] == n
        for k in ("logits", "cache_k", "cache_v"):
            got, want = outs["cuda"][k].float().cpu().numpy(), outs["cpu"][k].float().numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2, err_msg=k)


@pytest.mark.cuda
def test_smoke_lm_train_cell_card_matches_cpu(cuda):
    """Three qwen2.5 smoke train steps (T = 256, B = 2) on the card and on
    the CPU from the same weights and a fresh engine: metrics equal, loss
    within 2e-2, rows and params within 2 * lr * steps (bf16 sign flips of
    near-zero gradients, as in tests/test_torch_lm.py); two flash forward
    launches (the layer and its recompute) and one backward per layer and
    step."""
    shape = ShapeCell("train_4k", "train", {"seq_len": 256, "global_batch": 2})
    cells = {d: build_cell("qwen2.5-3b", "train_4k", smoke=True, shape_override=shape, device=d)
             for d in ("cpu", "cuda")}
    cfg = cells["cpu"].arch.model
    states = {d: c.init_state() for d, c in cells.items()}
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    for s in range(3):
        before = (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES)
        outs = {}
        for d, c in cells.items():
            states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
        assert (t_fa.LAUNCHES - before[0], t_fa.BWD_LAUNCHES - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        assert met["cuda"] == met["cpu"]
        np.testing.assert_allclose(float(outs["cuda"]["loss"]), float(outs["cpu"]["loss"]), atol=2e-2)
    rows = {d: c.engine.export_rows(states[d]["sparse"])["dim64"] for d, c in cells.items()}
    np.testing.assert_array_equal(rows["cuda"]["ids"], rows["cpu"]["ids"])
    np.testing.assert_allclose(rows["cuda"]["emb"], rows["cpu"]["emb"], rtol=0, atol=6e-3)
    for n, p in states["cpu"]["dense"].state_dict().items():
        np.testing.assert_allclose(states["cuda"]["dense"].state_dict()[n].cpu().numpy(), p.numpy(),
                                   rtol=0, atol=6e-3, err_msg=n)
