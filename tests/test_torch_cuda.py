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
from repro_torch.kernels.segment_reduce import ops as t_sr, ref as t_sr_ref
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
def test_bucketize_on_the_card_raises(cuda):
    spec = FeatureSpec("q", transform="bucketize", emb_dim=4, boundaries=(0.0, 1.0))
    r = Ragged(torch.zeros(4, device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(NotImplementedError, match="ROADMAP B4"):
        FeatureEngine([spec], cuda).apply({"q": r})


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
    counts = (t_fg.LAUNCHES, t_sr.LAUNCHES, t_sr.LAUNCHES_BWD, t_fs.LAUNCHES_ADD, t_fs.LAUNCHES_SET)
    for s in range(3):
        outs = {}
        for d, c in cells.items():
            states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        assert met["cuda"] == met["cpu"]
        np.testing.assert_allclose(float(outs["cuda"]["loss"]), float(outs["cpu"]["loss"]), atol=2e-2)
    now = (t_fg.LAUNCHES, t_sr.LAUNCHES, t_sr.LAUNCHES_BWD, t_fs.LAUNCHES_ADD, t_fs.LAUNCHES_SET)
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
def test_flash_kernel_refuses_gradients_and_bad_inputs(cuda):
    q, k, v = _flash_inputs(1, 64, 2, 1, 32, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP B7"):
        t_fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        t_fa.flash_attention(q, k, v)  # no gradient wanted: the kernel runs
    q = q.detach()
    with pytest.raises(ValueError):
        t_fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        t_fa.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        t_fa.flash_attention(q[:, :, :1], k.expand(1, 64, 2, 32), v)  # H not a multiple of Hk


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
