"""The port's multi-rank exchange, elastic restore, ZeRO-1 and compressed
gradient sums against the JAX package's ``shard_map`` versions on the CPU.

The port runs on four gloo ranks (spawned once for the module, meeting
through a ``FileStore``; subgroups of 2 and 3 ranks), the reference in one
subprocess with four forced host devices (meshes over the first 2, 3 or
4). Both take the same numpy inputs, made from a seed:

  * the exchange of one dim group (a sum and a mean feature) at D 2 and 3,
    with budgets that fit and with budgets that overflow the send buckets
    and the owner merge; at D 3 one rank has no live id at all. Plans and
    send buckets bit-equal, ``rows_r``, the pooled activations and the
    gradient reaching ``rows_r`` through the reply all_to_all within 1e-6,
    the summed counters equal; the D-rank activations equal the one-rank
    activations of the same global batch;
  * elastic restore: rows trained at 2 ranks, saved as their union and
    restored onto 1 and 3 ranks, and a JAX 4-device export restored onto 2
    ranks: the union equal and every row on its owner;
  * ``compressed_psum`` at D 2 and 4 (int8 payloads and int32 sums
    bit-equal, the floats within 1 ulp), ZeRO-1's chosen dimensions against
    ``zero1_pspec`` and its update at D 2 bit-equal to the unsharded one.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_work as work
from repro.optim import adamw as j_adamw
from repro_torch.core import exchange as t_exchange
from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.launch import mesh
from repro_torch.optim import adamw as t_adamw
from torch_ranks import finish, run_ranks, start_jax

B_LOC, NNZ = 4, 12
CASES = [(2, "normal"), (2, "tight"), (3, "normal"), (3, "tight")]
CASE_IDS = [f"d{d}-{k}" for d, k in CASES]

JAX_BODY = """
import pathlib
from repro.checkpoint import saver
from repro.core import exchange
from repro.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro.core.feature_engine import FeatureSpec
from repro.io.ragged import Ragged
from repro.optim import adamw
from repro.optim.sparse_adam import SparseAdamConfig

inp = dict(np.load(INPUTS))
out_dir = pathlib.Path(OUT_DIR)
sp = P("data")
out = {}

# the elastic export first: the port's ranks wait for it
n_dev = 4
mesh = mesh_of(n_dev)
eng = EmbeddingEngine([FeatureSpec("f", transform="hash", emb_dim=4, pooling="sum")], EngineConfig(
    mesh_axes=("data",), n_devices=n_dev, **EL_CFG))
vals = jnp.tile(jnp.asarray([3, 9, 11], jnp.int64), n_dev)
splits = jnp.tile(jnp.asarray([0, 2, 3], jnp.int32), n_dev)

def el_step(sp_state, vals, splits):
    st = jax.tree.map(lambda x: x[0], sp_state)
    ids = {"f": Ragged(vals, splits)}
    st, rr, pl, _ = eng.fetch_local(st, ids, jnp.int32(1))
    g = {k: jnp.ones_like(v) for k, v in rr.items()}
    st = eng.update_local(st, pl, g, SparseAdamConfig(lr=0.1), jnp.int32(1))
    return jax.tree.map(lambda x: x[None], st)

state = jax.jit(shard_map(el_step, mesh=mesh, in_specs=(sp, sp, sp), out_specs=sp,
                          check_vma=False))(eng.init_state(), vals, splits)
saver.save(eng.export_rows(state), out_dir / "jax4", step=1, n_shards=2)
(out_dir / "jax4.done").write_text("")

specs = [FeatureSpec("f", transform="hash", emb_dim=4, pooling="sum"),
         FeatureSpec("g", transform="hash", emb_dim=4, pooling="mean")]
for D, kind in CASES:
    mesh = mesh_of(D)
    eng = EmbeddingEngine(specs, EngineConfig(mesh_axes=("data",), n_devices=D, **CFGS[f"{D}-{kind}"]))
    spec = eng.groups["dim4"].exchange

    def step(st, fv, fs, gv, gs, wf, wg):
        st = jax.tree.map(lambda x: x[0], st)
        ids = {"f": Ragged(fv, fs), "g": Ragged(gv, gs)}
        send, _, _ = exchange.build_send(eng.engine_ids(ids)["dim4"], spec)
        st, rr, pl, met = eng.fetch_local(st, ids, jnp.int32(1))
        met = jax.lax.psum(met, ("data",))

        def lossf(rows):
            acts = eng.activations({"dim4": rows}, pl, ids)
            return jnp.sum(acts["f"] * wf) + jnp.sum(acts["g"] * wg), acts

        (_, acts), grad = jax.value_and_grad(lossf, has_aux=True)(rr["dim4"])
        p = pl["dim4"]
        per = {"send": send, "rows_r": rr["dim4"], "grad": grad, **{f: getattr(p, f) for f in FIELDS}}
        return jax.tree.map(lambda x: x[None], per), acts["f"], acts["g"], met

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(sp,) * 7, out_specs=(sp, sp, sp, P()),
                           check_vma=False))
    args = [inp[f"d{D}_f_vals"].reshape(-1), inp[f"d{D}_f_splits"].reshape(-1),
            inp[f"d{D}_g_vals"].reshape(-1), inp[f"d{D}_g_splits"].reshape(-1),
            inp[f"d{D}_w_f"].reshape(-1, 4), inp[f"d{D}_w_g"].reshape(-1, 4)]
    per, af, ag, met = fn(eng.init_state(), *map(jnp.asarray, args))
    for k, v in per.items():
        out[f"d{D}-{kind}/{k}"] = np.asarray(v)
    out[f"d{D}-{kind}/acts_f"], out[f"d{D}-{kind}/acts_g"] = np.asarray(af), np.asarray(ag)
    for k, v in met.items():
        out[f"d{D}-{kind}/met/{k}"] = np.asarray(v)

for D in (2, 4):
    def cps(g, e):
        g, e = g[0], e[0]
        summed, new_e = adamw.compressed_psum(g, ("data",), e)
        gf = g.astype(jnp.float32) + e
        scale = jnp.maximum(jax.lax.pmax(jnp.max(jnp.abs(gf)), ("data",)), 1e-12) / 127.0
        q = jnp.clip(jnp.round(gf / scale), -127, 127).astype(jnp.int8)
        isum = jax.lax.psum(q.astype(jnp.int32), ("data",))
        return summed[None], new_e[None], q[None], isum[None]

    res = jax.jit(shard_map(cps, mesh=mesh_of(D), in_specs=(sp, sp), out_specs=(sp,) * 4,
                            check_vma=False))(jnp.asarray(inp[f"cps{D}_g"]), jnp.asarray(inp[f"cps{D}_e"]))
    for k, v in zip(("summed", "new_error", "q", "isum"), res):
        out[f"cps{D}/{k}"] = np.asarray(v)
np.savez(out_dir / "jax.npz", **out)
"""


def make_inputs() -> dict:
    """Per device: B_LOC rows of up to 3 ids in [0, 30) for each feature
    (PAD after the live prefix), weights for the activations' loss; at D 3
    the last device has no live id. Elastic ids; compressed-sum inputs."""
    r = np.random.default_rng(0)
    inp = {}
    for D in (2, 3):
        for n in ("f", "g"):
            lens = r.integers(0, 4, size=(D, B_LOC))
            if D == 3:
                lens[-1] = 0
            splits = np.zeros((D, B_LOC + 1), np.int32)
            splits[:, 1:] = np.cumsum(lens, axis=1)
            vals = np.full((D, NNZ), -1, np.int64)
            for d in range(D):
                vals[d, :splits[d, -1]] = r.integers(0, 30, splits[d, -1])
            inp[f"d{D}_{n}_vals"], inp[f"d{D}_{n}_splits"] = vals, splits
            inp[f"d{D}_w_{n}"] = r.normal(size=(D, B_LOC, 4)).astype(np.float32)
    inp["el_vals"] = r.integers(0, 20, size=(2, 6)).astype(np.int64)
    inp["el_splits"] = np.tile(np.array([0, 2, 3, 6], np.int32), (2, 1))
    for D in (2, 4):
        inp[f"cps{D}_g"] = (r.normal(size=(D, 3000)) * r.choice([1e-3, 1.0, 30.0], size=(D, 1))).astype(np.float32)
        inp[f"cps{D}_e"] = (r.normal(size=(D, 3000)) * 1e-3).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank")
    inp = make_inputs()
    np.savez(d / "inputs.npz", **inp)
    cfgs = {f"{D}-{k}": work.exchange_cfg(D, k) for D, k in CASES}
    body = (f"INPUTS = {str(d / 'inputs.npz')!r}\nOUT_DIR = {str(d)!r}\nCASES = {CASES!r}\n"
            f"CFGS = {cfgs!r}\nEL_CFG = {work.elastic_cfg(4)!r}\nFIELDS = {work.PLAN_FIELDS!r}\n") + JAX_BODY
    jax_proc = start_jax(body, n_dev=4)
    try:
        ranks = run_ranks("torch_rank_work:exchange_ranks", 4, str(d / "store"), str(d / "inputs.npz"), str(d))
    finally:
        finish(jax_proc)
    ref = dict(np.load(d / "jax.npz"))
    return {"ranks": ranks, "ref": ref, "inp": inp, "dir": d}


def _ref(runs, D, kind, key):
    return runs["ref"][f"d{D}-{kind}/{key}"]


@pytest.mark.parametrize("D,kind", CASES, ids=CASE_IDS)
def test_send_buckets_and_plans_bit_equal(runs, D, kind):
    for r in range(D):
        got = runs["ranks"][r][f"d{D}_{kind}"]
        for k in ("send", *work.PLAN_FIELDS):
            np.testing.assert_array_equal(got[k], _ref(runs, D, kind, k)[r], err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("D,kind", CASES, ids=CASE_IDS)
def test_rows_activations_and_row_gradient_agree(runs, D, kind):
    for r in range(D):
        got = runs["ranks"][r][f"d{D}_{kind}"]
        for k in ("rows_r", "grad"):
            np.testing.assert_allclose(got[k], _ref(runs, D, kind, k)[r], rtol=0, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        for k in ("acts_f", "acts_g"):
            np.testing.assert_allclose(got[k], _ref(runs, D, kind, k)[r * B_LOC:(r + 1) * B_LOC],
                                       rtol=0, atol=1e-6, err_msg=f"rank {r} {k}")
    assert np.abs(_ref(runs, D, kind, "grad")).sum() > 0


@pytest.mark.parametrize("D,kind", CASES, ids=CASE_IDS)
def test_summed_counters_equal(runs, D, kind):
    want = {k.split("/")[-1]: int(v) for k, v in runs["ref"].items() if k.startswith(f"d{D}-{kind}/met/")}
    for r in range(D):
        got = {k.split("/")[-1]: v for k, v in runs["ranks"][r][f"d{D}_{kind}"]["metrics"].items()}
        assert got == want


@pytest.mark.parametrize("D", [2, 3])
def test_tight_budgets_overflow_both_stages(runs, D):
    met = runs["ranks"][0][f"d{D}_tight"]["metrics"]
    assert met["dim4/exch_send_overflow"] > 0 and met["dim4/exch_recv_overflow"] > 0
    assert runs["ranks"][0][f"d{D}_normal"]["metrics"]["dim4/exch_send_overflow"] == 0


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_activations_equal_one_rank(runs, D):
    """The reference's test_sharded_fetch_matches_single_device, in the port."""
    one = runs["ranks"][0][f"d{D}_one_rank"]
    for k in ("acts_f", "acts_g"):
        sharded = np.concatenate([runs["ranks"][r][f"d{D}_normal"][k] for r in range(D)])
        np.testing.assert_allclose(sharded, one[k], rtol=1e-6, atol=1e-6)
    assert np.abs(one["acts_f"]).sum() > 0


def _union(exports: list[dict]) -> dict:
    out = {}
    for key in exports[0]:
        ids = np.concatenate([e[key]["ids"] for e in exports])
        emb = np.concatenate([e[key]["emb"] for e in exports])
        order = np.argsort(ids)
        out[key] = (ids[order], emb[order])
    return out


def _owned(exports: list[dict]) -> None:
    D = len(exports)
    for r, e in enumerate(exports):
        for key, rows in e.items():
            own = t_exchange._owner_of(torch.from_numpy(rows["ids"]), D).numpy()
            assert (own == r).all(), f"rank {r} {key}: rows owned by {np.unique(own)}"


def _assert_union_equal(got: dict, want: dict) -> None:
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0])
        np.testing.assert_array_equal(got[key][1], want[key][1])
        assert want[key][0].size > 0


def test_elastic_restore_2_to_1(runs):
    trained = [runs["ranks"][r]["el2_own"] for r in range(2)]
    _owned(trained)
    eng = EmbeddingEngine(work.EL_SPECS, EngineConfig(n_devices=1, **work.elastic_cfg(1)), "cpu")
    back = eng.export_rows(eng.import_rows(work._restore_rows(runs["dir"] / "el2")))
    _assert_union_equal(_union([back]), _union(trained))


def test_elastic_restore_2_to_3(runs):
    trained = [runs["ranks"][r]["el2_own"] for r in range(2)]
    restored = [runs["ranks"][r]["el_2to3"] for r in range(3)]
    _owned(restored)
    _assert_union_equal(_union(restored), _union(trained))


def test_elastic_restore_jax_4_devices_onto_2_ranks(runs):
    want = work._restore_rows(runs["dir"] / "jax4")
    restored = [runs["ranks"][r]["el_j4to2"] for r in range(2)]
    _owned(restored)
    _assert_union_equal(_union(restored), _union([want]))
    assert want["dim4"]["ids"].size == 3


@pytest.mark.parametrize("D", [2, 4])
def test_compressed_psum_payloads_bit_equal(runs, D):
    for r in range(D):
        got = runs["ranks"][r][f"cps{D}"]
        for k in ("q", "isum"):
            np.testing.assert_array_equal(got[k], runs["ref"][f"cps{D}/{k}"][r], err_msg=f"rank {r} {k}")
    assert np.abs(runs["ref"][f"cps{D}/q"]).max() == 127


@pytest.mark.parametrize("D", [2, 4])
def test_compressed_psum_floats_within_one_ulp(runs, D):
    for r in range(D):
        got = runs["ranks"][r][f"cps{D}"]
        for k in ("summed", "new_error"):
            np.testing.assert_array_max_ulp(got[k], runs["ref"][f"cps{D}/{k}"][r], maxulp=1)


def test_zero1_dims_match_reference_rule():
    """Params under min_size, dimensions under 128 and an already-sharded
    first dimension: the same spec as the reference's zero1_pspec."""
    params = work.zero1_params()
    jspecs = {k: P(*work.ZERO1_SPECS.get(k, ())) for k in params}
    want = j_adamw.zero1_pspec(jspecs, {k: np.zeros(v.shape, np.float32) for k, v in params.items()},
                               min_size=work.ZERO1_MIN)
    got = t_adamw.zero1_pspec(work.ZERO1_SPECS, params, min_size=work.ZERO1_MIN)
    assert {k: tuple(v) for k, v in want.items()} == got
    assert t_adamw.zero1_dims(work.ZERO1_SPECS, params, work.ZERO1_MIN) == {
        "w_rows": 0, "w_cols": 1, "bias": None, "w_odd": 0, "w_tp": None, "w_narrow": 0}


def test_zero1_update_bit_equal_to_unsharded(runs):
    for r in range(2):
        z = runs["ranks"][r]["zero1"]
        assert all(all(step.values()) for step in z["equal"]), z["equal"]
        assert z["dims"] == t_adamw.zero1_dims(work.ZERO1_SPECS, work.zero1_params(), work.ZERO1_MIN)


def test_zero1_keeps_moments_of_this_ranks_slice_only(runs):
    got = [runs["ranks"][r]["zero1"]["moment_shapes"] for r in range(2)]
    assert got[0]["w_odd"] == (129, 300) and got[1]["w_odd"] == (128, 300)
    assert got[0]["w_cols"] == got[1]["w_cols"] == (64, 1024)
    assert got[0]["bias"] == (256,) and got[0]["w_tp"] == (512, 96)


def test_exchange_over_several_devices_needs_a_group():
    spec = t_exchange.ExchangeSpec(n_devices=2, u_budget=8, per_dest_cap=8, recv_budget=8)
    eng = EmbeddingEngine(work.EL_SPECS, EngineConfig(n_devices=2, **work.elastic_cfg(2)), "cpu")
    st = eng.init_state()["dim4"]
    with pytest.raises(ValueError, match="needs a process group"):
        t_exchange.fetch(st["idmap"].map(lambda x: x[0]), st["blocks"].map(lambda x: x[0]),
                         torch.tensor([1, 2]), spec, torch.tensor(1), True)


def test_init_group_refuses_unnamed_backends_and_missing_rendezvous(monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        mesh.init_group("mpi", rank=0, world_size=1, store_path="unused")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_group("gloo")
    assert mesh.n_devices(None) == 1
