# Tiered embedding storage: a host-DRAM backing tier beneath the device
# tier's hot-row cache, with pluggable admission and eviction policies.
from repro_torch.storage.host_store import HostStore  # noqa: F401
from repro_torch.storage.integration import StorageTrainerHooks  # noqa: F401
from repro_torch.storage.policies import (  # noqa: F401
    CachePolicy, FrequencyAdmissionPolicy, LFUPolicy, LRUPolicy, make_policy,
)
from repro_torch.storage.tiered import StorageConfig, TieredEmbeddingStore  # noqa: F401
