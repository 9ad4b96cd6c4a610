"""internlm2-20b (GQA: 8 query heads over 2 kv heads at smoke widths; 48
over 8 at published widths), JAX package against the PyTorch port on the
CPU: its config, its smoke train, prefill and decode cells and the train
driver (the cases of tests/torch_lm_arch_cases.py)."""
ARCH = "internlm2-20b"

from torch_lm_arch_cases import *  # noqa: E402,F401,F403
