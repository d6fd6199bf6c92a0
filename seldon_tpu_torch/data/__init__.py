"""Training data pipeline: token shards + native prefetching loader.

Port of seldon_tpu/data/__init__.py."""

from seldon_tpu_torch.data.loader import (
    TokenDataLoader,
    write_token_shard,
)

__all__ = ["TokenDataLoader", "write_token_shard"]
