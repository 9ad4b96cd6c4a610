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
from repro.kernels.segment_reduce import ops as j_sr
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.fused_gather import ops as t_fg
from repro_torch.kernels.fused_scatter import ops as t_fs
from repro_torch.kernels.segment_reduce import ops as t_sr


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
])
def test_gather_plain_matches_pallas(r_rows, d, k, id_dtype):
    r = np.random.default_rng(r_rows + k)
    table = r.normal(size=(r_rows, d)).astype(np.float32)
    ids = r.integers(-3, r_rows + 3, size=(k,)).astype(id_dtype)  # PAD and out-of-range
    ids[::7] = -1
    want = np.asarray(j_fg.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    got = t_fg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


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
