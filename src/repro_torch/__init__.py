"""repro_torch: Terra (imperative-symbolic co-execution) on PyTorch and CUDA.

The serving main path of ``src/repro/`` ported module for module: the same
trace/TraceGraph/co-execution engine, the pass pipeline, the llama-family
model and the paged continuous-batching scheduler, with the paged-attention
decode kernel written by hand for Hopper (``kernels/csrc``).  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
