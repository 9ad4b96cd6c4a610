"""The port's qwen2.5 smoke decode cells over two gloo ranks against the
JAX decode cells on a mesh of two forced host devices, on the CPU, in FP32
and MIXED: ``long_500k`` with its cache's sequence sharded over the ranks
(the distributed flash-decode: the softmax max and sums all-reduced), its
three steps writing positions 126 and 127 on rank 0 and 128 on rank 1, and
``decode_32k`` with its batch split over the ranks. Both sides start from
the reference cell's state (imported rows, a cache filled with random
bf16 values), which each rank loads through
``convert.decode_state_from_numpy``.

Held: each rank's batch its slice of the reference's; logits within 1e-5
(FP32) and ``MIXED_TOL`` (MIXED) of the reference's (every rank's the whole
batch's in ``long_500k``, its own rows in ``decode_32k``); the summed
metrics, ``pos`` and ``step`` equal; each rank's cache slice bit-equal to
the reference's where no step wrote, the written positions within one bf16
ulp (FP32) or ``MIXED_TOL``, and a position only on the rank that holds it.
The LM train and prefill cells refuse the group (ROADMAP A7g).
"""
import numpy as np
import pytest

import torch_rank_work as work
from test_torch_decode import TOLS, WRITTEN_TOLS
from torch_ranks import finish, run_ranks, start_jax

D = 2

JAX_BODY = """
import pathlib
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.io.ragged import Ragged
from repro.launch import lm_cell as j_lm
from repro.launch.common import CellOptions
from repro.models import layers

d = pathlib.Path(D_DIR)
mesh = mesh_of(2)
arch = get_config("qwen2.5-3b", smoke=True)
V = arch.model.vocab_size
FIELDS = ("keys", "occupied", "offsets", "last_use", "free_stack", "free_size", "next_row")
init, out, states = {}, {}, {}

def flat(tree, prefix):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, f"{prefix}{k}/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}

for case, name, params, pos0 in CASES:
    shape = ShapeCell(name, "decode", params)
    B = params["global_batch"]
    eng, gkey = j_lm._engine_for(arch.model, mesh, B if params.get("long_context") else B // 2, CellOptions())
    ids = np.asarray(eng.engine_ids({"tokens": Ragged(jnp.arange(V, dtype=jnp.int64),
                                                      jnp.array([0, V], jnp.int32))})[gkey])
    ids = np.delete(ids, np.arange(0, ids.size, 7))  # those tokens read as zero rows
    r = np.random.default_rng(5)
    rows = {gkey: {"ids": ids, "emb": r.normal(size=(ids.size, arch.model.d_model)).astype(np.float32),
                   "slots": {k: np.zeros((ids.size, arch.model.d_model), np.float32) for k in ("m", "v")},
                   "last_use": np.ones(ids.size, np.int32)}}
    cell = j_lm.build(arch, shape, mesh, CellOptions())
    with mesh:
        st = cell.init_state()
        st["sparse"] = eng.import_rows(rows)
        r = np.random.default_rng(11)
        shp = st["cache"]["k"].shape
        st["cache"] = {k: jnp.asarray(r.normal(size=shp).astype(np.float32), jnp.bfloat16) for k in ("k", "v")}
        st["pos"] = jnp.int32(pos0)
        host = jax.tree.map(np.asarray, st)
    init.update(flat({k: v for k, v in host.items() if k != "sparse"}, f"{case}/"))
    init[f"{case}/cache/k"] = host["cache"]["k"].astype(np.float32)
    init[f"{case}/cache/v"] = host["cache"]["v"].astype(np.float32)
    for g, v in host["sparse"].items():
        for i, f in enumerate(FIELDS):
            init[f"{case}/sparse/{g}/idmap/{i}"] = np.asarray(getattr(v["idmap"], f))
        init[f"{case}/sparse/{g}/blocks/emb"] = np.asarray(v["blocks"].emb)
        for k, s in v["blocks"].slots.items():
            init[f"{case}/sparse/{g}/blocks/slots/{k}"] = np.asarray(s)
    states[case] = (cell, st)
np.savez(d / "decode_init.npz", **init)  # the ranks start from it

for case, name, params, pos0 in CASES:
    cell, st0 = states[case]
    for prec in PRECS:
        j_lm.MIXED = layers.FP32 if prec == "fp32" else layers.MIXED
        with mesh:
            st = st0
            step = jax.jit(cell.step_fn)
            for s in range(STEPS):
                b = cell.make_batch(s)
                out[f"{case}/{prec}/batch/{s}"] = np.asarray(b)
                st, o = step(st, b)
                for k, v in o.items():
                    out[f"{case}/{prec}/{s}/{k}"] = np.asarray(v)
            out[f"{case}/{prec}/cache/k"] = np.asarray(st["cache"]["k"].astype(jnp.float32))
            out[f"{case}/{prec}/cache/v"] = np.asarray(st["cache"]["v"].astype(jnp.float32))
            out[f"{case}/{prec}/pos"] = np.asarray(st["pos"])
            out[f"{case}/{prec}/step"] = np.asarray(st["step"])
j_lm.MIXED = layers.MIXED
np.savez(d / "decode_jax.npz", **out)
"""
CASES = [(c[0], p) for c in work.DECODE_CASES for p in work.DECODE_PRECS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_ranks")
    body = (f"D_DIR = {str(d)!r}\nSTEPS = {work.DECODE_STEPS}\nCASES = {work.DECODE_CASES!r}\n"
            f"PRECS = {work.DECODE_PRECS!r}\n" + JAX_BODY)
    proc = start_jax(body, n_dev=D)
    ranks = run_ranks("torch_rank_work:decode_ranks", D, str(d / "store"), str(d))
    finish(proc)
    return {"ranks": ranks, "ref": dict(np.load(d / "decode_jax.npz")),
            "init": dict(np.load(d / "decode_init.npz"))}


def _case(case: str):
    return next(c for c in work.DECODE_CASES if c[0] == case)


def _long(case: str) -> bool:
    return bool(_case(case)[2].get("long_context"))


@pytest.mark.parametrize("case,prec", CASES)
def test_each_rank_takes_its_slice_of_the_reference_batch(runs, case, prec):
    want = runs["ref"][f"{case}/{prec}/batch/0"]
    for rank, r in enumerate(runs["ranks"]):
        mine = want if _long(case) else np.split(want, D)[rank]
        np.testing.assert_array_equal(r[case, prec]["batch"], mine)


@pytest.mark.parametrize("case,prec", CASES)
def test_logits_agree_with_the_reference_cell(runs, case, prec):
    for rank, r in enumerate(runs["ranks"]):
        for s, got in enumerate(r[case, prec]["logits"]):
            want = runs["ref"][f"{case}/{prec}/{s}/logits"]
            mine = want if _long(case) else np.split(want, D)[rank]
            np.testing.assert_allclose(got, mine, **TOLS[prec], err_msg=f"rank {rank} step {s}")


@pytest.mark.parametrize("case,prec", CASES)
def test_metrics_pos_and_step_equal(runs, case, prec):
    ref = runs["ref"]
    for r in runs["ranks"]:
        out = r[case, prec]
        for s, got in enumerate(out["metrics"]):
            want = {k.split("/", 3)[3]: int(v) for k, v in ref.items() if k.startswith(f"{case}/{prec}/{s}/")
                    and k.count("/") == 4}
            assert got == want
        assert out["pos"] == int(ref[f"{case}/{prec}/pos"]) == _case(case)[3] + work.DECODE_STEPS
        assert out["step"] == int(ref[f"{case}/{prec}/step"]) == 0


@pytest.mark.parametrize("case,prec", CASES)
def test_each_rank_holds_its_slice_of_the_reference_cache(runs, case, prec):
    """Bit-equal where no step wrote; the written positions within the
    written-position tolerance; a rank whose slice does not hold a
    position leaves it as it was (in ``long_500k`` rank 0 writes 126 and
    127, rank 1 writes 128)."""
    pos0 = _case(case)[3]
    written = np.arange(pos0, pos0 + work.DECODE_STEPS)
    for rank, r in enumerate(runs["ranks"]):
        for k in ("k", "v"):
            got = r[case, prec]["cache"][k]
            want, before = runs["ref"][f"{case}/{prec}/cache/{k}"], runs["init"][f"{case}/cache/{k}"]
            if _long(case):
                n = want.shape[2] // D
                lo = rank * n
                want, before, mine = want[:, :, lo:lo + n], before[:, :, lo:lo + n], written[
                    (written >= lo) & (written < lo + n)] - lo
            else:
                want, before, mine = np.split(want, D, axis=1)[rank], np.split(before, D, axis=1)[rank], written
            assert got.shape == want.shape
            mask = np.zeros(got.shape[2], bool)
            mask[mine] = True
            np.testing.assert_array_equal(got[:, :, ~mask], want[:, :, ~mask])
            np.testing.assert_array_equal(got[:, :, ~mask], before[:, :, ~mask])
            np.testing.assert_allclose(got[:, :, mask], want[:, :, mask], **WRITTEN_TOLS[prec])
            assert not np.array_equal(got[:, :, mask], before[:, :, mask])
    if _long(case):
        assert [list(written[(written >= r * 128) & (written < (r + 1) * 128)]) for r in range(D)] == [[126, 127], [128]]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_lm_train_and_prefill_cells_refuse_a_group(runs, shape_name):
    for r in runs["ranks"]:
        assert "run on one device only" in r[shape_name] and "A7g" in r[shape_name]
