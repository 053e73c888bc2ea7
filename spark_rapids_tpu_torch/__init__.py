"""spark_rapids_tpu_torch: the Spark SQL engine of spark_rapids_tpu,
ported to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The package imports torch and numpy only.  Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU with `device="cpu"`;
with no card and no explicit CPU device they raise.
"""
