"""MIND (arXiv:1904.08030): multi-interest network with dynamic routing (port
of ``repro/models/recsys/mind.py``).

embed_dim 64, 4 interest capsules, 3 routing iterations. Behavior-to-
Interest dynamic routing extracts K capsules from the behaviour sequence;
label-aware attention (power 2) mixes them for the target item. Training is
a sampled softmax over (positive, negatives); retrieval takes the best
interest's dot score against each candidate.

The routing logits start from a fixed draw, the reference's
``jax.random.normal(jax.random.PRNGKey(17), (K, T))``. ``routing_init``
draws it in numpy (threefry-2x32 on the flat index, bit-equal; the
uniform's mantissa trick; the float32 erfinv polynomial, within a few
float32 ulps of XLA's), once per (K, T) and device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.models.layers import MIXED, Precision, dense, dense_apply
from repro_torch.models.recsys.common import sampled_softmax_loss


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    n_neg: int = 4
    label_pow: float = 2.0
    vocab: int = 10_000_000


def feature_specs(cfg: MINDConfig) -> list[FeatureSpec]:
    d = cfg.embed_dim
    return [
        FeatureSpec("hist_items", transform="hash", emb_dim=d, pooling="none",
                    max_len=cfg.seq_len, shared_table="items"),
        FeatureSpec("target_item", transform="hash", emb_dim=d, pooling="sum",
                    shared_table="items"),
        FeatureSpec("neg_items", transform="hash", emb_dim=d, pooling="none",
                    max_len=cfg.n_neg, shared_table="items"),
    ]


# ------------------------------------------------------------ routing init

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erfinv's float32 polynomial (Giles), for w = -log1p(-x²) < 5 and >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 counter pairs (x0, x1)."""
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """erfinv by the float32 polynomial XLA lowers it to; the logarithm is
    taken in float64 and each Horner step is fused (one rounding), as XLA's
    CPU code contracts it. Within a few float32 ulps of XLA's."""
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _normal_draw(seed: int, k: int, t: int) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), (k, t), float32)`` with threefry's
    partitionable counters: each element's flat index as (high, low) words,
    the two output words XORed."""
    with np.errstate(over="ignore"):
        idx = np.arange(k * t, dtype=np.uint64)
        hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        b0, b1 = _threefry2x32(0, seed, hi, lo)
    bits = b0 ^ b1
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - np.float32(1.0)
    lo_v = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_v, floats * (np.float32(1.0) - lo_v) + lo_v)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(k, t)


@functools.lru_cache(maxsize=None)
def _routing_init(k: int, t: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_normal_draw(17, k, t)).to(device)


def routing_init(k: int, t: int, device) -> torch.Tensor:
    """The fixed routing-logit draw (k, t), fp32, on ``device`` (one copy
    per device, kept)."""
    return _routing_init(k, t, torch.device(device))


# ------------------------------------------------------------------- model

def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)


def _label_aware(caps: torch.Tensor, target: torch.Tensor, p: float) -> torch.Tensor:
    """caps (B, K, d), target (B, d) → user vector (B, d)."""
    s = torch.einsum("bkd,bd->bk", caps, target)
    a = torch.softmax(torch.pow(torch.abs(s) + 1e-9, p) * torch.sign(s), dim=-1)
    return torch.einsum("bk,bkd->bd", a, caps)


class MIND(nn.Module):
    def __init__(self, cfg: MINDConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.embed_dim
        s = torch.randn((d, d), generator=gen, dtype=torch.float32) / np.float32(np.sqrt(d))
        self.S = nn.Parameter(s.to(device))  # shared bilinear map, used as hist @ S
        self.out = dense(d, d, gen, device=device)

    def interests(self, hist: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
        """B2I dynamic routing. hist: (B, T, d) → capsules (B, K, d), fp32."""
        b, t, _ = hist.shape
        k = self.cfg.n_interests
        mask = torch.any(hist != 0.0, dim=-1)[:, None, :].to(torch.float32)   # (B, 1, T)
        e = (prec.cast(hist) @ prec.cast(self.S)).to(torch.float32)          # (B, T, d)
        logits = routing_init(k, t, hist.device)[None].expand(b, k, t)
        for _ in range(self.cfg.capsule_iters):
            w = torch.softmax(logits, dim=1) * mask
            caps = _squash(torch.matmul(w, e))
            logits = logits + torch.matmul(caps, e.transpose(1, 2))
        w = torch.softmax(logits, dim=1) * mask
        caps = _squash(torch.matmul(w, e))
        return F.relu(dense_apply(self.out, prec.cast(caps), prec)).to(torch.float32)

    def user(self, acts: dict, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
        """(label-aware user vector (B, d), target rows (B, d)), fp32."""
        caps = self.interests(acts["hist_items"], prec)
        tgt = acts["target_item"].to(torch.float32)
        return _label_aware(caps, tgt, self.cfg.label_pow), tgt

    def forward(self, acts: dict, dense: dict, prec: Precision = MIXED) -> torch.Tensor:
        """Serving: the user vector · the target item, (B,)."""
        user, tgt = self.user(acts, prec)
        return (user * tgt).sum(-1)


def init(cfg: MINDConfig, seed: int = 0, device=None) -> MIND:
    return MIND(cfg, seed, device).eval()


def _check(model: MIND, cfg: MINDConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("model was built for another MINDConfig")


def apply(model: MIND, cfg: MINDConfig, acts: dict, dense: dict,
          prec: Precision = MIXED) -> torch.Tensor:
    """fp32 scores (B,), with the reference's ``apply(params, cfg, ...)`` signature."""
    _check(model, cfg)
    return model(acts, dense, prec)


def loss(model: MIND, cfg: MINDConfig, acts: dict, dense: dict,
         prec: Precision = MIXED) -> torch.Tensor:
    """Sampled softmax of the target against ``neg_items``."""
    _check(model, cfg)
    user, tgt = model.user(acts, prec)
    pos_logit = (user * tgt).sum(-1)
    neg_logit = torch.matmul(acts["neg_items"].to(torch.float32), user[..., None])[..., 0]  # (B, n_neg)
    return sampled_softmax_loss(pos_logit, neg_logit)


def score_candidates(model: MIND, cfg: MINDConfig, acts: dict, dense: dict,
                     cand_rows: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
    """Retrieval (B = 1): the best interest's dot score against each row, (Nc,)."""
    _check(model, cfg)
    caps = model.interests(acts["hist_items"], prec)                     # (1, K, d)
    return (caps[0] @ cand_rows.to(torch.float32).T).max(dim=0).values
