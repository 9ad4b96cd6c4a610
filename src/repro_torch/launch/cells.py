"""Cell dispatcher (port of ``repro/launch/cells.py``): (arch-id,
shape-name, device) → assembled Cell."""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.common import Cell, CellOptions


def build_cell(arch_id: str, shape_name: str, opts: CellOptions = CellOptions(),
               smoke: bool = False, shape_override: ShapeCell | None = None,
               device=None, group=None) -> Cell:
    """Runs on ``cuda`` unless ``device`` names another device; raises when
    no card is present and no device was named. ``group`` (a
    ``torch.distributed`` process group, ``launch/mesh.py``) shards the cell
    over its ranks, the reference's mesh; None is one device."""
    arch = get_config(arch_id, smoke=smoke)
    return build_arch_cell(arch, shape_override or arch.shape(shape_name), opts, device, group)


def build_arch_cell(arch: ArchConfig, shape: ShapeCell, opts: CellOptions = CellOptions(),
                    device=None, group=None) -> Cell:
    """``build_cell`` for a config the caller made (published widths, a cut
    vocab)."""
    if arch.family == "recsys":
        from repro_torch.launch import recsys_cell

        return recsys_cell.build(arch, shape, opts, device, group)
    if arch.family == "gnn":
        from repro_torch.launch import gnn_cell

        return gnn_cell.build(arch, shape, opts, device, group)
    if arch.family == "lm":
        from repro_torch.launch import lm_cell

        return lm_cell.build(arch, shape, opts, device, group)
    raise NotImplementedError(f"the {arch.family} family is not ported yet")
