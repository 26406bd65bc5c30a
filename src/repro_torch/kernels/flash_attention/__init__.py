"""Flash attention: plain versions (``ref``, ``jnp_impl``), the CUDA
kernel's wrapper (``kernel``) and the ``impl=`` dispatch (``ops``)."""
from .ops import flash_attention
from .ref import dense_attention

__all__ = ["flash_attention", "dense_attention"]
