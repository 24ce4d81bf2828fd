"""Atomic, async checkpointing in the reference's on-disk format."""
from repro_torch.checkpoint.store import (CheckpointStore, dir_checksums,
                                          sha256_file)

__all__ = ["CheckpointStore", "dir_checksums", "sha256_file"]
