"""Atomic checkpoints of the retrieval state, in the reference's on-disk
format (`index/*.npy`, `delta/*.npy`, `raw/*.npy`, `meta.json`): each
package loads the other's directories.  The LM `save` / `restore` /
`latest_step` come with the training stack (ROADMAP A14)."""

from repro_torch.checkpoint.store import (
    load_engine,
    load_index,
    load_raw_store,
    save_engine,
    save_index,
)

__all__ = [
    "load_engine",
    "load_index",
    "load_raw_store",
    "save_engine",
    "save_index",
]
