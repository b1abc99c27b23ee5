"""The benchmark of the PyTorch/CUDA port (``gan_lib_tensorflow_tpu_torch``):
one cell per run, driven by the data files beside this one. See
``README.md``; the entry is ``python3 -m gan_bench.run``."""
