"""The twin of ``examples/quickstart.py`` (``repro_torch/examples/
quickstart.py``) against the example on the CPU, loaded by file path with
its ``MIXED`` set to FP32 for the run (nothing in ``examples/`` changes),
and ``_pool``'s sum and mean pooling (the quickstart's ``clicks`` column is
the repo's one mean pooling) against the reference's, forward and
gradient."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.io.ragged as j_ragged
from repro.core import embedding_engine as j_engine
from repro.core.feature_engine import FeatureSpec as JSpec
from repro.models import layers as j_layers
from repro_torch import convert
from repro_torch.core import embedding_engine as t_engine
from repro_torch.core.feature_engine import FeatureSpec as TSpec
from repro_torch.examples import quickstart as t_qs
from repro_torch.io.ragged import Ragged
from repro_torch.models import layers as t_layers

STEPS = 5


def _load_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"
    spec = importlib.util.spec_from_file_location("reference_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    """STEPS FP32 steps of the example's ``train_step`` and of the twin's,
    from the example's MLP weights, on the example's batches."""
    j_qs = _load_example()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_qs, "MIXED", j_layers.FP32)
    try:
        sparse = jax.tree.map(lambda x: x[0], j_qs.engine.init_state())
        dense, opt = j_qs.mlp, j_qs.adamw.init(j_qs.mlp)
        j_out = []
        for step in range(1, STEPS + 1):
            sparse, dense, opt, loss, met = j_qs.train_step(sparse, dense, opt, j_qs.make_batch(step % 10),
                                                            jnp.int32(step))
            j_out.append((float(loss), {k: int(v) for k, v in met.items()}))
    finally:
        mp.undo()
    qs = t_qs.Quickstart("cpu", prec=t_layers.FP32)
    qs.mlp.load_state_dict(convert.params_from_tree(qs.mlp, jax.tree.map(np.asarray, j_qs.mlp)))
    t_out = []
    for step in range(1, STEPS + 1):
        loss, met = qs.train_step(t_qs.make_batch(step % 10, "cpu"), step)
        t_out.append((float(loss), {k: int(v) for k, v in met.items()}))
    return j_qs, j_out, t_out


def test_quickstart_batches_and_specs_equal(runs):
    j_qs, _, _ = runs
    assert [(s.name, s.transform, s.emb_dim, s.pooling) for s in t_qs.SPECS] == \
        [(s.name, s.transform, s.emb_dim, s.pooling) for s in j_qs.SPECS]
    for seed in (0, 7):
        jb, tb = j_qs.make_batch(seed), t_qs.make_batch(seed, "cpu")
        for k in jb:
            np.testing.assert_array_equal(tb[k].values.numpy(), np.asarray(jb[k].values), err_msg=k)
            np.testing.assert_array_equal(tb[k].row_splits.numpy(), np.asarray(jb[k].row_splits), err_msg=k)


def test_quickstart_loss_and_metrics_agree(runs):
    """FP32: the loss within 1e-5 at every step, the engine's counters equal."""
    _, j_out, t_out = runs
    for step, ((jl, jm), (tl, tm)) in enumerate(zip(j_out, t_out), 1):
        assert abs(tl - jl) <= 1e-5, (step, tl, jl)
        assert tm == jm, step
    assert t_out[0][0] != t_out[-1][0]


def test_quickstart_main_trains_on_the_cpu(capsys):
    """The twin's ``main()`` at the example's settings (MIXED, 100 steps):
    the example's own check, the loss below 0.67."""
    assert t_qs.main(["--device", "cpu"]) < 0.67
    assert "quickstart done" in capsys.readouterr().out


@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_pool_sum_and_mean_equal(pooling, split_dtype):
    """``_pool``'s sum and mean branches against the reference's, forward and
    gradient: empty rows, a padding tail past the live values, int32 and
    int64 splits. Within 1e-6 (the same fp32 adds and one division)."""
    r = np.random.default_rng(5 + (pooling == "mean"))
    n_rows, dim, budget = 16, 16, 64
    lens = r.integers(0, 6, size=n_rows)
    lens[::3] = 0
    splits = np.minimum(np.concatenate([[0], np.cumsum(lens)]), budget - 7).astype(split_dtype)
    rows = r.normal(size=(budget, dim)).astype(np.float32)
    g = r.normal(size=(n_rows, dim)).astype(np.float32)
    jr = j_ragged.Ragged(jnp.zeros(budget, jnp.int64), jnp.asarray(splits))
    want, vjp = jax.vjp(lambda x: j_engine._pool(x, jr, JSpec("c", emb_dim=dim, pooling=pooling)),
                        jnp.asarray(rows))
    (want_g,) = vjp(jnp.asarray(g))
    tr = Ragged(torch.zeros(budget, dtype=torch.int64), torch.from_numpy(splits))
    x = torch.from_numpy(rows).requires_grad_()
    got = t_engine._pool(x, tr, TSpec("c", emb_dim=dim, pooling=pooling))
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    assert not got.detach()[lens == 0].any() and not got_g[int(splits[-1]):].any()
