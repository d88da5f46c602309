"""Cross-process transport of the port (``sharding``): the byte mailboxes
and rounds under :class:`repro_torch.core.comm.TorchDistComm`."""

from .sharding import StoreByteTransport, dumps, global_any

__all__ = ["StoreByteTransport", "dumps", "global_any"]
