"""Atomic checkpoints in the reference's on-disk format: each package loads
the other's directories.  The LM training state (`save` / `restore` /
`latest_step`: params, AdamW moments, step) and the retrieval state
(`index/*.npy`, `delta/*.npy`, `raw/*.npy`, `meta.json`)."""

from repro_torch.checkpoint.store import (
    latest_step,
    load_engine,
    load_index,
    load_raw_store,
    restore,
    save,
    save_engine,
    save_index,
)

__all__ = [
    "latest_step",
    "load_engine",
    "load_index",
    "load_raw_store",
    "restore",
    "save",
    "save_engine",
    "save_index",
]
