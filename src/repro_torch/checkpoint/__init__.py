from .engine import (CheckpointEngine, latest_step, manifest_path,
                     restore_sharded, save_sharded)

__all__ = ["CheckpointEngine", "save_sharded", "restore_sharded",
           "latest_step", "manifest_path"]
