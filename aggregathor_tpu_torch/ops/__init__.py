"""Hand-written CUDA kernels of the GAR hot path (``kernels``), their sources
(``csrc/``) and the nvcc build that loads them (``build``)."""
