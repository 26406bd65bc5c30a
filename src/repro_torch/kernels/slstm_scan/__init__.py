"""The sLSTM recurrence: plain version (``ref``), the CUDA kernel's
wrapper (``kernel``) and the dispatch on the tensor's device (``ops``)."""
from .ops import slstm_scan
from .ref import slstm_scan_ref

__all__ = ["slstm_scan", "slstm_scan_ref"]
