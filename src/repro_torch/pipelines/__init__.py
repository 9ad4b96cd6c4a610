from repro_torch.pipelines.trainer import (  # noqa: F401
    PreemptionGuard, StragglerEvent, StragglerWatchdog, TrainConfig, Trainer,
    TrainResult,
)
