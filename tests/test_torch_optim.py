"""The PyTorch port's optimizers against the JAX package on the CPU:
SparseAdam(W) on Blocks rows, dense AdamW with the global-norm clip active,
and the conversion of the reference's AdamW state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as j_blocks
from repro.optim import adamw as j_adamw
from repro.optim import sparse_adam as j_sadam
from repro_torch.convert import params_from_tree
from repro_torch.core import blocks as t_blocks
from repro_torch.models.recsys.dlrm import DLRM, DLRMConfig
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import sparse_adam as t_sadam

# The same fp32 arithmetic; norms may be summed in another order. Sparse
# moments are written back as m0 + (m1 - m0), whose rounding follows the
# size of m0 rather than of the result: an absolute floor of 1e-8 (|m0| < 1).
RTOL = 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("weight_decay,clip,step", [(0.0, None, 1), (0.01, 1.0, 7), (0.1, 0.05, 1000)])
def test_sparse_adam_rows_agree(weight_decay, clip, step):
    """Two updates in a row (lazy moments), invalid slots and out-of-range
    offsets, updated in place through a view of a stacked table."""
    r = np.random.default_rng(step)
    n_rows, dim, k = 64, 16, 40
    emb = r.normal(size=(n_rows, dim)).astype(np.float32)
    m = r.normal(scale=0.1, size=(n_rows, dim)).astype(np.float32)
    v = r.random(size=(n_rows, dim)).astype(np.float32) * 0.01
    offsets = r.permutation(n_rows)[:k].astype(np.int32)
    valid = r.random(k) < 0.8
    offsets[~valid & (r.random(k) < 0.5)] = n_rows + 3  # invalid and out of range
    cfg = dict(lr=1e-2, weight_decay=weight_decay, grad_clip_norm=clip)
    jb = j_blocks.Blocks(emb=jnp.asarray(emb), slots={"m": jnp.asarray(m), "v": jnp.asarray(v)})
    stacked = t_blocks.Blocks(emb=_t(emb)[None], slots={"m": _t(m)[None], "v": _t(v)[None]})
    tb = stacked.map(lambda x: x[0])
    for s in (step, step + 1):
        g = r.normal(size=(k, dim)).astype(np.float32)
        jb = j_sadam.apply_row_updates(j_sadam.SparseAdamConfig(**cfg), jb, jnp.asarray(offsets),
                                       jnp.asarray(g), jnp.asarray(valid), jnp.int32(s))
        tb = t_sadam.apply_row_updates(t_sadam.SparseAdamConfig(**cfg), tb, _t(offsets), _t(g),
                                       _t(valid), torch.tensor(s, dtype=torch.int32))
    np.testing.assert_allclose(stacked.emb[0].numpy(), np.asarray(jb.emb), rtol=RTOL, atol=1e-7)
    for s in ("m", "v"):
        np.testing.assert_allclose(stacked.slots[s][0].numpy(), np.asarray(jb.slots[s]),
                                   rtol=RTOL, atol=1e-8, err_msg=s)
    untouched = np.setdiff1d(np.arange(n_rows), offsets[valid])
    np.testing.assert_array_equal(stacked.emb[0].numpy()[untouched], emb[untouched])


def _tree(r, shapes):
    return {part: {f"l{i}": {"w": r.normal(size=s).astype(np.float32),
                             "b": r.normal(size=s[1:]).astype(np.float32)}
                   for i, s in enumerate(dims)} for part, dims in shapes.items()}


def _flat(tree) -> dict:
    """Reference tree → the port's {param name: tensor} (w transposed)."""
    return {f"{p}.{l}.{'weight' if k == 'w' else 'bias'}": _t(v.T if k == "w" else v)
            for p, layers in tree.items() for l, d in layers.items() for k, v in d.items()}


@pytest.mark.parametrize("clip,step", [(1.0, 1), (1.0, 5), (None, 3)])
def test_adamw_agrees_with_clipping_active(clip, step):
    r = np.random.default_rng(step)
    shapes = {"bot": [(5, 8), (8, 4)], "top": [(7, 3), (3, 1)]}
    params, grads = _tree(r, shapes), _tree(r, shapes)  # |grads| ≈ 9 ≫ the clip at 1.0
    state = {"m": _tree(r, shapes), "v": jax.tree.map(np.abs, _tree(r, shapes))}
    cfg = dict(lr=1e-2, grad_clip_norm=clip)
    jp, js = j_adamw.update(j_adamw.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
                            jnp.int32(step))
    tp, tg = _flat(params), _flat(grads)
    ts = t_adamw.update(t_adamw.AdamWConfig(**cfg), tp, tg,
                        {k: _flat(v) for k, v in state.items()}, torch.tensor(step))
    for got, want in [(tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])]:
        want = _flat(jax.tree.map(np.asarray, want))
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=RTOL, atol=1e-7, err_msg=n)


def test_adamw_init_and_state_conversion():
    cfg = DLRMConfig(n_dense=3, n_sparse=2, embed_dim=4, bot_mlp=(6, 4), top_mlp=(5, 1))
    r = np.random.default_rng(0)
    shapes = {"bot": [(3, 6), (6, 4)], "top": [(7, 5), (5, 1)]}
    opt = {"m": _tree(r, shapes), "v": _tree(r, shapes)}
    model = DLRM(cfg)
    got = {k: params_from_tree(model, opt[k]) for k in ("m", "v")}
    for k in ("m", "v"):
        assert set(got[k]) == set(_flat(opt[k]))
        for n, w in _flat(opt[k]).items():
            np.testing.assert_array_equal(got[k][n].numpy(), w.numpy())
    z = t_adamw.init(got["m"])
    assert all(not t.any() and t.shape == got["m"][n].shape for n, t in z["m"].items())
