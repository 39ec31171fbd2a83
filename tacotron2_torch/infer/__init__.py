from .sharded import ShardedSynthesizer

__all__ = ["ShardedSynthesizer"]
