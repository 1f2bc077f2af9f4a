from repro_torch.kvcache.manager import (  # noqa: F401
    BlockAllocator, KVCacheManager, OutOfBlocks, kv_pages_for,
    paged_cache_shape,
)
