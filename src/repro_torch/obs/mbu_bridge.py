"""MBU / roofline → registry bridge (DESIGN.md §9); a copy of
``repro/obs/mbu_bridge.py``. ``record_mbu`` takes any object with the
fields of the reference's ``core.mbu.MBUResult`` (``name``, ``mbu``,
``achieved_bw``, ``essential_bytes``, ``wall_s``, ``bandwidth_intensity``,
``moved_bytes``); the port's twin of ``core/mbu.py`` is still to come.

The paper's point (§1.4.2) is that sparse-path quality is invisible to
MFU; MBU is the right instrument. This bridge folds kernel-quality numbers
— ``core.mbu`` measurements and ``roofline.analysis`` structural terms —
into the SAME ``MetricsRegistry`` namespace as the runtime counters, so a
single telemetry snapshot answers both "how fast was the run" and "how
good are the kernels":

    mbu/<op>/mbu                achieved / peak-HBM-bandwidth fraction
    mbu/<op>/bandwidth_intensity  essential / moved bytes (1.0 = perfectly fused)
    mbu/<op>/achieved_gbps      essential_bytes / wall_s
    roofline/<arch>/<shape>/<mesh>/<term>   compiled dry-run terms
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.obs.registry import MetricsRegistry, sanitize


def record_mbu(result, registry: MetricsRegistry,
               prefix: str = "mbu") -> dict[str, float]:
    """Fold one ``core.mbu.MBUResult`` into gauges. Returns the names→values
    it wrote (handy for BENCH json)."""
    base = f"{prefix}/{sanitize(result.name)}"
    out = {
        f"{base}/mbu": float(result.mbu),
        f"{base}/achieved_gbps": float(result.achieved_bw) / 1e9,
        f"{base}/essential_mb": float(result.essential_bytes) / 1e6,
        f"{base}/wall_ms": float(result.wall_s) * 1e3,
    }
    if result.bandwidth_intensity is not None:
        out[f"{base}/bandwidth_intensity"] = float(result.bandwidth_intensity)
    if result.moved_bytes is not None:
        out[f"{base}/moved_mb"] = float(result.moved_bytes) / 1e6
    for k, v in out.items():
        registry.gauge(k).set(v)
    return out


def record_roofline(arch: str, shape: str, mesh: str, terms: Mapping,
                    registry: MetricsRegistry) -> dict[str, float]:
    """Fold one dry-run roofline row (benchmarks/run.py ``_roofline_summary``
    shape) into gauges under ``roofline/<arch>/<shape>/<mesh>/``. Non-numeric
    terms (e.g. ``bound``) are skipped — they belong in the JSONL event, not
    a gauge."""
    base = f"roofline/{sanitize(arch)}/{sanitize(shape)}/{sanitize(mesh)}"
    out = {}
    for k, v in terms.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = f"{base}/{sanitize(k)}"
        registry.gauge(name).set(float(v))
        out[name] = float(v)
    return out
