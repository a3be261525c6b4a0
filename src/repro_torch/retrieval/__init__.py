"""The online query path: shard layout, device step and engine."""
