"""The JAX package's ``tools/`` on the torch side. Each module runs as
``python -m gan_lib_tensorflow_tpu_torch.tools.<name>`` with its
counterpart's flags, defaults and JSON keys, on ``--device cuda`` unless
``--device cpu`` is given:

- ``convert_inception_weights``: torchvision ``.pt[h]``, keras ``.npz``/
  ``.h5`` or flax ``.npz`` InceptionV3 weights -> the npz that
  ``eval/inception_v3.py:load_params_npz`` reads
- ``prepack_dataset``: ``.npz`` file(s) -> a packed store, or a PGGAN pyramid
- ``bench_step``, ``bench_pggan``, ``decompose_pggan``, ``probe_cond_cost``:
  train-step timers at the reference tools' configurations
- ``calibrate_rungs``: FLOPs per step (``torch.utils.flop_counter``), roofline
  and MFU against the H100's bf16 peak and a measured matmul rate
- ``bench_eval``, ``bench_loader``, ``bench_kstep``: the eval accumulators,
  the loaders, and chained steps against one CUDA graph of K steps
"""
