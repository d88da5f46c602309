from .ops import delta_zigzag, fit_columns, uvarint_encode64, uvarint_pack64

__all__ = ["delta_zigzag", "fit_columns", "uvarint_encode64",
           "uvarint_pack64"]
