from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .compress import ef_int8_compress, ef_int8_decompress

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "ef_int8_compress", "ef_int8_decompress"]
