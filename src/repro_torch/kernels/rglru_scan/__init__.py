"""The RG-LRU scan: plain version (``ref``), the CUDA kernel's wrapper
(``kernel``) and the dispatch on the tensor's device (``ops``)."""
from .ops import rglru_scan
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_bwd_ref", "rglru_scan_ref"]
