from repro_torch.pipelines.trainer import (  # noqa: F401
    PreemptionGuard, StragglerEvent, StragglerWatchdog, TrainConfig, Trainer,
    TrainResult,
)
from repro_torch.pipelines.windows import OnlineWindowPipeline, WindowResult, multitask_loss  # noqa: F401
