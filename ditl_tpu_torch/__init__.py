"""ditl_tpu_torch: the PyTorch and CUDA port of ``ditl_tpu`` for NVIDIA H100.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find, imports ``torch`` and never ``jax`` or
anything of ``ditl_tpu``. Its entry points run on the card (``"cuda"``)
unless the caller passes ``device="cpu"``. ROADMAP.md lists what is ported.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
