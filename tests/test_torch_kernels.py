"""The PyTorch port's kernel ops on the CPU (their plain versions) against
the JAX package's Pallas ops in interpret mode. The CUDA kernels themselves
are held against the plain versions in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io.ragged import Ragged as JRagged
from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.fused_gather import ops as j_fg
from repro.kernels.fused_scatter import ops as j_fs, ref as j_fs_ref
from repro.kernels.fused_transform import ops as j_ft, ref as j_ft_ref
from repro.kernels.segment_reduce import ops as j_sr
from repro.kernels.sequence_tile import ops as j_st, ref as j_st_ref
from repro_torch.kernels.flash_attention import ops as t_fa, ref as t_fa_ref
from repro_torch.kernels.fused_gather import ops as t_fg
from repro_torch.kernels.fused_scatter import ops as t_fs
from repro_torch.kernels.fused_transform import ops as t_ft
from repro_torch.kernels.segment_reduce import ops as t_sr
from repro_torch.kernels.sequence_tile import ops as t_st


SHAPES = [(1, 8, 1), (33, 8, 1), (100, 16, 7), (512, 64, 512), (1024, 128, 300), (777, 32, 111)]


def _seg_inputs(n, d, s, sort, seed=0):
    r = np.random.default_rng(seed + n + d + s)
    vals = r.normal(size=(n, d)).astype(np.float32)
    seg = r.integers(-1, s + 2, size=(n,)).astype(np.int32)  # out-of-range on both sides
    return vals, (np.sort(seg) if sort else seg)


@pytest.mark.parametrize("n,d,s", SHAPES)
@pytest.mark.parametrize("sort", [True, False])
def test_segment_sum_plain_matches_pallas(n, d, s, sort):
    vals, seg = _seg_inputs(n, d, s, sort)
    want = np.asarray(j_sr.segment_sum(jnp.asarray(vals), jnp.asarray(seg), s))
    got = t_sr.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), s, sorted_ids=sort)
    tol = 1e-5 if sort else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _csr_inputs(n_rows, d, budget, seed):
    """Values and row_splits with empty rows and a padding tail past the live nnz."""
    r = np.random.default_rng(seed)
    lengths = r.integers(0, 4, size=n_rows)
    lengths[::5] = 0
    splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    splits = np.minimum(splits, budget - 2).astype(np.int32)  # leave a tail of at least 2
    return r.normal(size=(budget, d)).astype(np.float32), splits


@pytest.mark.parametrize("n_rows,d,budget", [(1, 8, 4), (32, 16, 80), (512, 128, 1024), (100, 13, 150)])
def test_segment_sum_csr_plain_matches_pallas(n_rows, d, budget):
    vals, splits = _csr_inputs(n_rows, d, budget, seed=n_rows + d)
    seg = JRagged(jnp.zeros(budget, jnp.int64), jnp.asarray(splits)).segment_ids()
    want = np.asarray(j_sr.segment_sum(jnp.asarray(vals), seg, n_rows))
    got = t_sr.segment_sum_csr(torch.from_numpy(vals), torch.from_numpy(splits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,s", [(64, 16, 9), (300, 8, 40)])
def test_segment_mean_plain_matches_pallas(n, d, s):
    vals, seg = _seg_inputs(n, d, s, sort=True, seed=1)
    want = np.asarray(j_sr.segment_mean(jnp.asarray(vals), jnp.asarray(seg), s))
    got = t_sr.segment_mean(torch.from_numpy(vals), torch.from_numpy(seg), s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("r_rows,d,k,id_dtype", [
    (1, 8, 5, np.int32), (100, 16, 300, np.int32), (1000, 128, 64, np.int64), (37, 5, 50, np.int64),
    (500, 8, 77, np.int64), (200, 8, 1000, np.int32),     # the MSE step's D, K not a multiple of 32
    (60, 2048, 45, np.int32), (33, 2048, 8, np.int64),   # the LM's D
])
def test_gather_plain_matches_pallas(r_rows, d, k, id_dtype):
    r = np.random.default_rng(r_rows + k)
    table = r.normal(size=(r_rows, d)).astype(np.float32)
    ids = r.integers(-3, r_rows + 3, size=(k,)).astype(id_dtype)  # PAD and out-of-range
    ids[::7] = -1
    want = np.asarray(j_fg.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    got = t_fg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


# The slab gather's cases: (name, R, D, K, id range [lo, hi), rows_blk, slab,
# id dtype). "straddle" is the partial-tail trap (most of its 200 rows read
# zero: the first run straddles the 1,024 window edge, the last run's min is
# the padding's id 0); "one_pad" puts one PAD id (clamped to 0) in a run of
# high ids, zeroing the other 127 rows; "small" has R < slab and R % 8 != 0.
SLAB_CASES = [
    ("reference", 2048, 64, 512, 0, 384, 128, 512, np.int32),
    ("straddle", 2048, 16, 200, 1000, 1300, 128, 512, np.int32),
    ("one_pad", 2048, 32, 128, 1536, 2048, 128, 512, np.int64),
    ("out_of_range", 1000, 16, 700, -40, 1040, 128, 512, np.int64),
    ("small", 100, 8, 300, 0, 100, 128, 512, np.int32),
    ("d1", 4096, 1, 1000, 0, 4096, 128, 512, np.int64),
    ("d5", 3000, 5, 777, 0, 3000, 64, 256, np.int32),
    ("d16_windows", 8192, 16, 2048, 0, 8192, 128, 512, np.int64),
    ("d128", 4096, 128, 640, 0, 600, 128, 512, np.int32),
]


def _slab_inputs(name, r_rows, d, k, lo, hi, id_dtype):
    """A finite table and sorted ids (the reference's one-hot product turns a
    non-finite row anywhere in a window into NaN for the whole run)."""
    r = np.random.default_rng(r_rows * 7 + d + k)
    table = r.normal(size=(r_rows, d)).astype(np.float32)
    ids = np.sort(r.integers(lo, hi, size=(k,))).astype(id_dtype)
    if name == "one_pad":
        ids[0] = -1
    return table, ids


@pytest.mark.parametrize("name,r_rows,d,k,lo,hi,rows_blk,slab,id_dtype", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_gather_slab_plain_matches_pallas(name, r_rows, d, k, lo, hi, rows_blk, slab, id_dtype):
    table, ids = _slab_inputs(name, r_rows, d, k, lo, hi, id_dtype)
    want = np.asarray(j_fg.gather_rows(jnp.asarray(table), jnp.asarray(ids), interpret=True,
                                       mode="slab", rows_blk=rows_blk, slab=slab))
    got = t_fg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids), mode="slab",
                           rows_blk=rows_blk, slab=slab)
    assert np.array_equal(got.numpy(), want)
    zeros = int((~want.any(axis=1)).sum())
    if name == "straddle":  # run 0's window is [512, 1024); run 1's is [0, 512)
        assert zeros == int((ids[:128] >= 1024).sum()) + (k - 128) > 150
    if name == "one_pad":
        assert zeros == 127


def test_gather_slab_reads_an_unaligned_view_and_refuses_bad_arguments():
    table, ids = _slab_inputs("reference", 2048, 64, 512, 0, 384, np.int64)
    flat = torch.zeros(table.size + 1)
    view = flat[1:].view(table.shape)  # contiguous, 4 bytes off a 16-byte boundary
    view.copy_(torch.from_numpy(table))
    want = np.asarray(j_fg.gather_rows(jnp.asarray(table), jnp.asarray(ids), interpret=True, mode="slab"))
    assert np.array_equal(t_fg.gather_rows(view, torch.from_numpy(ids), mode="slab").numpy(), want)
    with pytest.raises(ValueError):
        t_fg.gather_rows(view, torch.from_numpy(ids), mode="window")
    with pytest.raises(ValueError):
        t_fg.gather_rows(view, torch.from_numpy(ids), mode="slab", rows_blk=0)


def _scatter_inputs(r_rows, d, k, id_dtype, seed):
    """Unique ids with invalid slots and out-of-range ids (both sides)."""
    r = np.random.default_rng(seed)
    table = r.normal(size=(r_rows, d)).astype(np.float32)
    ids = r.permutation(r_rows + 4)[:k].astype(id_dtype) - 2
    rows = r.normal(size=(k, d)).astype(np.float32)
    valid = r.random(k) < 0.75
    return table, ids, rows, valid


@pytest.mark.parametrize("r_rows,d,k,id_dtype", [
    (32, 8, 1, np.int32), (64, 16, 17, np.int64), (256, 128, 64, np.int32), (40, 5, 30, np.int64),
])
@pytest.mark.parametrize("op", ["add", "set"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_scatter_plain_matches_pallas(r_rows, d, k, id_dtype, op, with_valid):
    table, ids, rows, valid = _scatter_inputs(r_rows, d, k, id_dtype, seed=r_rows + k)
    v = valid if with_valid else None
    jv = None if v is None else jnp.asarray(v)
    # the Pallas op takes ids in range only (it clamps nothing): hold it on
    # the in-range slots, and the jnp reference on all of them
    j_op = j_fs.scatter_add_rows if op == "add" else j_fs.scatter_set_rows
    j_ref = j_fs_ref.scatter_add_rows if op == "add" else j_fs_ref.scatter_set_rows
    t_op = t_fs.scatter_add_rows if op == "add" else t_fs.scatter_set_rows
    want = np.asarray(j_ref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows), jv))
    stacked = torch.from_numpy(table.copy())[None]
    got = t_op(stacked[0], torch.from_numpy(ids), torch.from_numpy(rows),
               None if v is None else torch.from_numpy(v))
    assert got.data_ptr() == stacked.data_ptr()  # in place, through the view
    np.testing.assert_allclose(stacked[0].numpy(), want, rtol=1e-6, atol=0)
    live = (ids >= 0) & (ids < r_rows)
    pallas = np.asarray(j_op(jnp.asarray(table), jnp.asarray(np.where(live, ids, 0)),
                             jnp.asarray(rows), jnp.asarray(live & (valid if with_valid else True))))
    np.testing.assert_allclose(stacked[0].numpy(), pallas, rtol=1e-6, atol=0)


def test_scatter_with_no_slots_leaves_the_table():
    table = torch.randn(8, 4)
    before = table.clone()
    for op in (t_fs.scatter_add_rows, t_fs.scatter_set_rows):
        op(table, torch.zeros(0, dtype=torch.int32), torch.zeros(0, 4))
    assert torch.equal(table, before)


@pytest.mark.parametrize("n,d,s", SHAPES)
def test_segment_sum_vjp_matches_pallas(n, d, s):
    vals, seg = _seg_inputs(n, d, s, sort=False, seed=4)
    g = np.random.default_rng(n).normal(size=(s, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_sr.segment_sum(v, jnp.asarray(seg), s), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(t_sr.segment_sum(v, torch.from_numpy(seg), s), v, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_rows,d,budget", [(1, 8, 4), (32, 16, 80), (512, 128, 1024), (100, 13, 150)])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_segment_sum_csr_vjp_matches_pallas(n_rows, d, budget, split_dtype):
    """The CSR gradient (segment_expand_csr) against the reference's VJP on
    the Ragged segment ids: empty rows, a padding tail, exact."""
    vals, splits = _csr_inputs(n_rows, d, budget, seed=n_rows + d + 1)
    splits = splits.astype(split_dtype)
    g = np.random.default_rng(budget).normal(size=(n_rows, d)).astype(np.float32)
    seg = JRagged(jnp.zeros(budget, jnp.int64), jnp.asarray(splits)).segment_ids()
    _, vjp = jax.vjp(lambda v: j_sr.segment_sum(v, seg, n_rows), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(vals).requires_grad_()
    out = t_sr.segment_sum_csr(v, torch.from_numpy(splits))
    (got,) = torch.autograd.grad(out, v, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[splits[-1]:].any()
    # a strided gradient (a column of a stacked one) gives the same rows
    wide = torch.zeros((n_rows, 3, d))
    wide[:, 1] = torch.from_numpy(g)
    np.testing.assert_array_equal(
        t_sr.segment_expand_csr(wide[:, 1], torch.from_numpy(splits), budget).numpy(), np.asarray(want))


def _group_inputs(n_feat, d, split_dtype, seed):
    """One group's routed rows: n_feat sum features of 24 rows each (nnz
    budget 60, empty rows, a padding tail), the second of them with every
    row empty, and a non-sum feature's 20 rows after the first and before
    the last sum feature; 7 rows past the last slice."""
    r = np.random.default_rng(seed)
    n_rows, budget = 24, 60
    offsets, splits, ofs = [], [], 0
    for f in range(n_feat):
        if f in (1, n_feat - 1) and n_feat > 1:
            ofs += 20  # the rows of a feature pooled otherwise
        lengths = r.integers(0, 5, size=n_rows)
        lengths[::4] = 0
        if f == 1:
            lengths[:] = 0
        sp = np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget - 3).astype(split_dtype)
        offsets.append(ofs)
        splits.append(sp)
        ofs += budget
    vals = r.normal(size=(ofs + 7, d)).astype(np.float32)
    return vals, splits, offsets, [budget] * n_feat


@pytest.mark.parametrize("n_feat", [1, 3, 26])
@pytest.mark.parametrize("d", [8, 13, 128])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_segment_sum_csr_group_plain_matches_pallas(n_feat, d, split_dtype):
    """The grouped sum (its plain version) against the Pallas segment_sum
    run per feature on slices of one ``vals``, within 1e-5; its gradient of
    the whole ``vals`` bit-equal to jax.vjp of the concatenated per-feature
    sums: zero on the other feature's rows, the padding tails and the rows
    of a feature whose gradient is missing (None), the first feature's
    gradient a strided column of a wider one."""
    vals, splits, offsets, sizes = _group_inputs(n_feat, d, split_dtype, seed=n_feat + d)
    segs = [JRagged(jnp.zeros(n, jnp.int64), jnp.asarray(sp)).segment_ids() for sp, n in zip(splits, sizes)]
    n_rows = [sp.shape[0] - 1 for sp in splits]

    def j_group(v):
        return jnp.concatenate([j_sr.segment_sum(v[o:o + n], seg, s)
                                for o, n, seg, s in zip(offsets, sizes, segs, n_rows)])

    want, vjp = jax.vjp(j_group, jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    outs = t_sr.segment_sum_csr_group(v, [torch.from_numpy(sp) for sp in splits], offsets, sizes)
    assert len(outs) == n_feat and all(o.shape == (s, d) for o, s in zip(outs, n_rows))
    np.testing.assert_allclose(torch.cat(outs).detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if n_feat > 1:
        assert not outs[1].detach().any()  # every row of the second feature is empty
    r = np.random.default_rng(d)
    g = [r.normal(size=(s, d)).astype(np.float32) for s in n_rows]
    missing = n_feat - 1 if n_feat > 1 else None  # the last feature's gradient is None
    if missing is not None:
        g[missing][:] = 0.0
    (want_g,) = vjp(jnp.asarray(np.concatenate(g)))
    wide = torch.from_numpy(np.stack([np.zeros_like(g[0]), g[0], np.zeros_like(g[0])], axis=1))
    pairs = [(outs[0], wide[:, 1])] + [(o, torch.from_numpy(x)) for f, (o, x) in enumerate(zip(outs, g))
                                       if 0 < f != missing]
    (got_g,) = torch.autograd.grad([o for o, _ in pairs], v, [x for _, x in pairs])
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert not got_g[offsets[-1] + sizes[-1]:].any()


def test_segment_sum_csr_group_takes_empty_features_and_refuses_overlaps():
    """A feature of no rows pools to (0, D); slices out of order, overlapping
    or past the values are refused."""
    vals = torch.randn(30, 4)
    sp = torch.tensor([0, 2, 5], dtype=torch.int32)
    empty, full = t_sr.segment_sum_csr_group(vals, [torch.zeros(1, dtype=torch.int32), sp], [0, 10], [10, 20])
    assert empty.shape == (0, 4)
    assert torch.equal(full, t_sr.segment_sum_csr(vals[10:], sp))
    for offsets, sizes in [([10, 0], [5, 5]), ([0, 4], [5, 5]), ([0, 26], [5, 5])]:
        with pytest.raises(ValueError):
            t_sr.segment_sum_csr_group(vals, [sp, sp], offsets, sizes)


# flash attention: the port's plain version (the CPU path of ops.flash_fwd)
# against the JAX Pallas kernel in interpret mode, on the shapes of
# tests/test_kernels.py and with grouped kv heads. Tolerances as there:
# 2e-3 in fp32 (online against one-pass softmax), 3e-2 in bf16.

def _qkv(b, t, h, hk, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, t, h, hd)).astype(np.float32),
            r.normal(size=(b, t, hk, hd)).astype(np.float32),
            r.normal(size=(b, t, hk, hd)).astype(np.float32))


def _jax_flash(q, k, v, causal, dtype=jnp.float32):
    """O (B, T, H, hd) and LSE (B, H, T) of the Pallas kernel, kv heads expanded."""
    from repro.models.attention import _expand_kv

    b, t, h, _ = q.shape
    g = h // k.shape[2]
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    o, res = j_fa._fwd_impl(jq, _expand_kv(jk, g), _expand_kv(jv, g), causal, None)
    lse = np.asarray(res[4])[:, :t].reshape(b, h, t)
    return np.asarray(o.astype(jnp.float32)), lse


@pytest.mark.parametrize("b,t,h,hk,hd", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 128), (1, 200, 1, 1, 32), (1, 200, 8, 1, 16),
])
def test_flash_plain_matches_pallas(b, t, h, hk, hd):
    q, k, v = _qkv(b, t, h, hk, hd, seed=b * t + h + hd)
    want_o, want_lse = _jax_flash(q, k, v, True)
    got_o, got_lse = t_fa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert got_lse.shape == (b, h, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-3, atol=2e-3)


def test_flash_plain_matches_pallas_not_causal():
    q, k, v = _qkv(1, 128, 4, 2, 64, seed=5)
    want_o, want_lse = _jax_flash(q, k, v, False)
    got_o, got_lse = t_fa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,t,h,hk,hd", [(1, 128, 2, 2, 64), (2, 128, 4, 2, 16)])
def test_flash_plain_matches_pallas_bf16(b, t, h, hk, hd):
    q, k, v = _qkv(b, t, h, hk, hd, seed=7)
    want_o, _ = _jax_flash(q, k, v, True, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = t_fa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want_o, rtol=3e-2, atol=3e-2)


# flash attention backward: the port's plain version (the CPU path of the op's
# backward) against jax.grad of the Pallas op in interpret mode, whose
# backward runs the Pallas flash_bwd. The JAX op takes the kv heads expanded,
# so the expansion sits inside the differentiated function and jax.grad
# returns dK and dV summed over each group. 2e-3 in fp32, as
# tests/test_kernels.py::test_flash_grads (online against one-pass softmax).

def _do(b, t, h, hd, seed):
    return np.random.default_rng(seed).normal(size=(b, t, h, hd)).astype(np.float32)


@pytest.mark.parametrize("b,t,h,hk,hd", [(1, 128, 2, 1, 64), (2, 256, 4, 2, 128), (1, 200, 8, 2, 32)])
def test_flash_bwd_plain_matches_pallas(b, t, h, hk, hd):
    from repro.models.attention import _expand_kv

    q, k, v = _qkv(b, t, h, hk, hd, seed=b * t + h + hd + 1)
    do = _do(b, t, h, hd, seed=t + hd)
    g = h // hk

    def f(q, k, v):
        return jnp.sum(j_fa.flash_attention(q, _expand_kv(k, g), _expand_kv(v, g), True) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = t_fa.flash_fwd(tq, tk, tv)
    got = t_fa_ref.flash_bwd(tq, tk, tv, o, lse, tdo)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3, err_msg=name)


def _ref_autograd(q, k, v, do, causal):
    """dQ, dK, dV by torch autograd through the plain forward."""
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o, _ = t_fa_ref.flash_fwd(q, k, v, causal)
    return torch.autograd.grad(o, (q, k, v), do)


@pytest.mark.parametrize("b,t,h,hk,hd,causal", [
    (1, 128, 2, 1, 64, True), (2, 256, 4, 2, 128, True), (1, 200, 8, 2, 32, True), (2, 96, 4, 4, 16, False),
])
def test_flash_bwd_plain_matches_autograd(b, t, h, hk, hd, causal):
    """The step-by-step backward against autograd of the plain forward:
    the same fp32 arithmetic in another order, 1e-5."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, t, h, hk, hd, seed=t + h))
    do = torch.from_numpy(_do(b, t, h, hd, seed=hd))
    o, lse = t_fa_ref.flash_fwd(q, k, v, causal)
    got = t_fa_ref.flash_bwd(q, k, v, o, lse, do, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, _ref_autograd(q, k, v, do, causal)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("loss", ["weighted", "sum"])
def test_flash_op_gradient_on_cpu(loss):
    """The op's autograd.Function on CPU tensors: its backward is the plain
    one (no kernel launch is counted), LSE is not differentiable, and a
    zero-stride dO (the gradient of a plain sum) is taken as it is."""
    b, t, h, hk, hd = 2, 100, 4, 2, 32
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(b, t, h, hk, hd, seed=3))
    w = torch.from_numpy(_do(b, t, h, hd, seed=4))
    before = (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES)
    o, lse = t_fa.flash_fwd(q, k, v)
    assert o.requires_grad and not lse.requires_grad
    out = (o * w).sum() if loss == "weighted" else o.sum()
    got = torch.autograd.grad(out, (q, k, v))
    assert (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES) == before
    do = w if loss == "weighted" else torch.ones_like(w)
    for name, a, want in zip(("dq", "dk", "dv"), got, _ref_autograd(q.detach(), k.detach(), v.detach(), do, True)):
        np.testing.assert_allclose(a.numpy(), want.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


# fused bucketize: the port's plain version (the CPU path of
# ops.fused_bucketize) against the Pallas kernel in interpret mode, on the
# sweep and the boundary-exactness inputs of tests/test_kernels.py. Exact.

def _bucket_table(r, c, width_hi=20, grid=False):
    widths = r.integers(1, width_hi, size=(c,))
    bnds, offs = [], [0]
    for w in widths:
        col = r.choice(np.arange(-5.0, 5.0, 0.5), w, replace=False) if grid else r.normal(size=w)
        bnds.extend(np.sort(col))
        offs.append(len(bnds))
    return np.array(bnds, np.float32), np.array(offs, np.int32)


def _bucketize_both(vals, cids, bnds, offs):
    want = np.asarray(j_ft.fused_bucketize(jnp.asarray(vals), jnp.asarray(cids), jnp.asarray(bnds),
                                           jnp.asarray(offs)))
    got = t_ft.fused_bucketize(*(torch.from_numpy(x) for x in (vals, cids, bnds, offs)))
    assert got.dtype == torch.int64
    return got.numpy(), want


@pytest.mark.parametrize("n,c", [(7, 1), (100, 3), (5000, 64)])
def test_bucketize_plain_matches_pallas(n, c):
    r = np.random.default_rng(n + c)
    bnds, offs = _bucket_table(r, c)
    vals = r.normal(size=(n,)).astype(np.float32)
    cids = r.integers(0, c, size=(n,)).astype(np.int32)
    got, want = _bucketize_both(vals, cids, bnds, offs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_bucketize_plain_matches_pallas_on_boundaries(seed):
    """Values on a boundary, one float step either side of it (subnormal
    beside a 0.0 boundary, which XLA compares as zero), ±inf, NaN, -0.0 and
    subnormals; fp64 input (cast to fp32 as the reference's wrapper does)."""
    r = np.random.default_rng(seed)
    c = int(r.integers(1, 9))
    bnds, offs = _bucket_table(r, c, width_hi=10, grid=True)
    on = r.choice(bnds, 64)
    vals = np.concatenate([on, np.nextafter(on, np.float32(np.inf)), np.nextafter(on, np.float32(-np.inf)),
                           np.array([np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45, 1e-39, -1e-39],
                                    np.float32)]).astype(np.float32)
    cids = r.integers(0, c, size=vals.shape).astype(np.int32)
    got, want = _bucketize_both(vals, cids, bnds, offs)
    np.testing.assert_array_equal(got, want)
    w = offs[cids + 1] - offs[cids]
    assert (got >= 0).all() and (got <= w).all()
    got64, _ = _bucketize_both(vals.astype(np.float64), cids, bnds, offs)
    np.testing.assert_array_equal(got64, want)


@pytest.mark.parametrize("c", [1, 2, 5, 20])
def test_bucketize_plain_matches_pallas_on_out_of_range_ids(c):
    """Every column id from -(C+3) to C+2 (and the int32 extremes): the
    offsets read as jnp reads them, so -2 reads column C - 1 and -1 or >= C
    an empty range. Bit-equal to the Pallas kernel and to the JAX reference."""
    r = np.random.default_rng(c)
    bnds, offs = _bucket_table(r, c, width_hi=12)
    ids = np.concatenate([np.arange(-(c + 3), c + 3), [np.iinfo(np.int32).max, np.iinfo(np.int32).min]])
    cids = np.repeat(ids, 7).astype(np.int32)
    vals = r.normal(scale=2.0, size=cids.shape).astype(np.float32)
    vals[::7] = np.inf
    got, want = _bucketize_both(vals, cids, bnds, offs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_ft_ref.fused_bucketize(
        jnp.asarray(vals), jnp.asarray(cids), jnp.asarray(bnds), jnp.asarray(offs))))


def test_bucketize_plain_on_the_out_of_range_example():
    """Boundaries [0, 1, 2 | -1, 5], every value 1.5: ids -3, -2, -1, 0, 2,
    5 give 2 1 0 2 0 0, as the JAX reference and the Pallas kernel do."""
    bnds, offs = np.array([0, 1, 2, -1, 5], np.float32), np.array([0, 3, 5], np.int32)
    cids, vals = np.array([-3, -2, -1, 0, 2, 5], np.int32), np.full(6, 1.5, np.float32)
    got, want = _bucketize_both(vals, cids, bnds, offs)
    np.testing.assert_array_equal(got, [2, 1, 0, 2, 0, 0])
    np.testing.assert_array_equal(want, [2, 1, 0, 2, 0, 0])


def test_bucketize_plain_matches_pallas_with_empty_columns():
    """Width-0 columns (first, between and last) give 0 for every value,
    ±inf and NaN included, as the Pallas kernel does."""
    r = np.random.default_rng(11)
    widths = [0, 4, 0, 0, 9, 0]
    bnds = np.concatenate([np.sort(r.normal(size=w)) for w in widths]).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    cids = np.repeat(np.arange(len(widths), dtype=np.int32), 40)
    vals = r.normal(scale=2.0, size=cids.shape).astype(np.float32)
    vals[::10], vals[1::10], vals[2::10] = np.inf, -np.inf, np.nan
    got, want = _bucketize_both(vals, cids, bnds, offs)
    np.testing.assert_array_equal(got, want)
    assert not got[np.isin(cids, [0, 2, 3, 5])].any()


# sequence tile: the port's plain version against the Pallas kernel in
# interpret mode on the sweep of tests/test_kernels.py, and its gradient
# (sequence_untile) against jax.vjp of the reference's plain formula: empty
# rows, rows longer than k, a padding tail. Exact.

def _tile_inputs(r, rows, maxlen, d, tail):
    lens = r.integers(0, maxlen + 1, size=(rows,))
    splits = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    n = max(int(splits[-1]) + tail, 1)
    return r.normal(size=(n, d)).astype(np.float32), splits


@pytest.mark.parametrize("rows,maxlen,d,k", [
    (1, 1, 8, 2), (5, 6, 16, 3), (32, 10, 128, 4), (16, 3, 64, 8), (9, 12, 13, 5),
])
def test_sequence_tile_plain_matches_pallas(rows, maxlen, d, k):
    r = np.random.default_rng(rows * maxlen + d + k)
    vals, splits = _tile_inputs(r, rows, maxlen, d, tail=0)
    want = np.asarray(j_st.sequence_tile(jnp.asarray(vals), jnp.asarray(splits), k))
    got = t_st.sequence_tile(torch.from_numpy(vals), torch.from_numpy(splits), k)
    assert got.shape == (rows, k * d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,maxlen,d,k,tail", [
    (1, 1, 8, 2, 0), (5, 6, 16, 3, 4), (32, 10, 8, 8, 7), (16, 3, 50, 8, 0), (9, 12, 13, 5, 3),
])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_sequence_untile_matches_jax_vjp(rows, maxlen, d, k, tail, split_dtype):
    r = np.random.default_rng(rows + maxlen * d + k + tail)
    vals, splits = _tile_inputs(r, rows, maxlen, d, tail)
    splits = splits.astype(split_dtype)
    g = r.normal(size=(rows, k * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_st_ref.sequence_tile(v, jnp.asarray(splits), k), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(t_st.sequence_tile(v, torch.from_numpy(splits), k), v, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[splits[-1]:].any()
    direct = t_st.sequence_untile(torch.from_numpy(g).view(rows, k, d), torch.from_numpy(splits), vals.shape[0])
    assert torch.equal(direct, got)


# The untile's edge cases, each against jax.vjp of the reference's plain
# formula: (row lengths, splits[0], padding tail, D, k). Rows of length
# k - 1, k and 10k, empty rows, a first split past 0, no rows at all.
UNTILE_EDGES = [
    ([3, 0, 2, 3, 40, 0, 1], 0, 5, 8, 4),       # 10k, k - 1, k, empty
    ([5, 4, 0, 50, 2], 7, 0, 13, 5),            # splits[0] > 0, 10k
    ([0, 0, 8, 7, 80, 0], 11, 6, 16, 8),        # the MSE k, both ends
    ([], 3, 10, 8, 4),                          # S = 0: head and tail only
    ([0, 0, 0], 2, 4, 8, 2),                    # only empty rows
    ([1, 30, 2], 0, 0, 128, 3),
]


@pytest.mark.parametrize("lengths,head,tail,d,k", UNTILE_EDGES)
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_sequence_untile_edge_cases_match_jax_vjp(lengths, head, tail, d, k, split_dtype):
    r = np.random.default_rng(len(lengths) + head + d + k)
    splits = (head + np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])).astype(split_dtype)
    n = int(splits[-1]) + tail
    vals = r.normal(size=(n, d)).astype(np.float32)
    g = r.normal(size=(len(lengths), k * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_st_ref.sequence_tile(v, jnp.asarray(splits), k), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    got = t_st.sequence_untile(torch.from_numpy(g).view(len(lengths), k, d), torch.from_numpy(splits), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[:head].any() and not got.numpy()[splits[-1]:].any()
