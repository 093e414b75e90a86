"""sina-tpu: a reference-based sequence aligner on JAX.

Re-implements the capabilities of SINA (the SILVA Incremental Aligner)
as a batched JAX engine with a CUDA kernel for the profile DP: k-mer reference search, POA-graph NAST
alignment against a fixed reference MSA, homology search and LCA
taxonomy classification.  See DESIGN.md for the architecture map.
"""

__version__ = "0.1.0"

from .sequence import Sequence  # noqa: F401
from . import alphabet  # noqa: F401
