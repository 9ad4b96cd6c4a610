"""Online-learning windows and multitask losses (port of
``repro/pipelines/windows.py``, paper §2.1).

  * ``OnlineWindowPipeline`` — continuous training over a stream of table
    windows (e.g. hourly partitions): evaluate window k before training it
    (the one-pass protocol), train it, then evict stale embedding rows.
  * ``multitask_loss`` — several task losses over shared activations,
    weighted into one scalar for one backward pass.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.pipelines.trainer import Trainer


@dataclasses.dataclass
class WindowResult:
    window: int
    pre_eval: dict          # metrics on this window BEFORE training it
    train_metrics: list


class OnlineWindowPipeline:
    """Train → advance over windowed data with between-window eviction.

    ``make_window_iter(w)`` yields the batches of window w; ``eval_step`` is
    a (state, batch) → metrics function that trains nothing.
    """

    def __init__(self, trainer: Trainer, make_window_iter: Callable[[int], Iterator],
                 eval_step: Callable[[Any, Any], dict] | None = None,
                 steps_per_window: int = 50):
        self.trainer = trainer
        self.make_window_iter = make_window_iter
        self.eval_step = eval_step
        self.steps_per_window = steps_per_window

    def run(self, state, n_windows: int) -> tuple[Any, list[WindowResult]]:
        results = []
        step0 = 0
        for w in range(n_windows):
            pre = {}
            if self.eval_step is not None:
                batch = next(iter(self.make_window_iter(w)))
                pre = {k: float(v) for k, v in self.eval_step(state, batch).items()
                       if (v.dim() if isinstance(v, torch.Tensor) else 0) == 0}
            self.trainer.cfg.total_steps = step0 + self.steps_per_window
            res = self.trainer.run(state, self.make_window_iter(w), start_step=step0)
            state = res.state
            step0 += res.steps_run
            # between-window eviction (stale-feature GC)
            if self.trainer.evict_fn is not None:
                state = self.trainer.evict_fn(state, max(step0 - self.trainer.cfg.evict_age_steps, 0))
            results.append(WindowResult(w, pre, res.metrics_history))
        return state, results


def multitask_loss(task_losses: dict[str, torch.Tensor], weights: dict[str, float] | None = None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted multitask scalarisation; returns (total, per-task detached)."""
    weights = weights or {}
    total = torch.zeros((), dtype=torch.float32, device=next((v.device for v in task_losses.values()), None))
    for name, loss in task_losses.items():
        total = total + torch.tensor(weights.get(name, 1.0), dtype=torch.float32) * loss
    return total, {f"loss_{k}": v.detach() for k, v in task_losses.items()}
