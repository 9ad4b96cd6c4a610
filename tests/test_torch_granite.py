"""granite-20b (MQA: 8 query heads over one kv head at smoke widths; 48
over one at published widths), JAX package against the PyTorch port on the
CPU: its config, its smoke train, prefill and decode cells and the train
driver (the cases of tests/torch_lm_arch_cases.py)."""
ARCH = "granite-20b"

from torch_lm_arch_cases import *  # noqa: E402,F401,F403
