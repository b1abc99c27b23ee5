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
- ``import_tf1_checkpoint``: a reference TF1 ``Saver`` checkpoint -> the
  port's step-0 checkpoint, read by ``tf1_bundle`` (a tensor-bundle reader
  without TensorFlow)
- ``report_run``: a run directory's ``log.jsonl`` and ``step_*.pt``
  checkpoints -> the loss-curve-shape report
- ``prepack_synthetic``: the ``rich`` synthetic images -> a packed store or
  PGGAN pyramid, byte-equal to the reference tool's
- ``plot_run``, ``plot_ladder``, ``plot_dose_response``: a run's losses and
  FID, a PGGAN ladder's W-distance and GP, the SWD dose response, drawn in
  numpy by ``figure`` (the text in PNG ``tEXt`` chunks, no font drawn)
- ``doctor``: the card, its toolchain, both kernels, the host libraries and
  CPU ranks, each probed in a subprocess with a timeout; one JSON report

``verify_all.sh`` drives the port's CLIs end to end on the card after the
doctor (``bash gan_lib_tensorflow_tpu_torch/tools/verify_all.sh``).
"""
