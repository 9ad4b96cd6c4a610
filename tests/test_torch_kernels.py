"""The PyTorch port's kernel ops on the CPU (their plain versions) against
the JAX package's Pallas ops in interpret mode. The CUDA kernels themselves
are held against the plain versions in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io.ragged import Ragged as JRagged
from repro.kernels.fused_gather import ops as j_fg
from repro.kernels.segment_reduce import ops as j_sr
from repro_torch.kernels.fused_gather import ops as t_fg
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
