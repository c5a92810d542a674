"""pbwt_tpu_torch: the PyTorch/CUDA port of pbwt-tpu.

A second package beside ``pbwt_tpu``, which stays the reference it is held
against output for output. The port imports torch and never jax; its host
layers are pbwt_tpu's numpy and C code (:mod:`pbwt_tpu_torch.host`), and
every TPU kernel on its path is a CUDA kernel written for Hopper
(``csrc/``), each with a plain-torch twin that the CPU route runs.

Layers:
  CLI           pbwt_tpu_torch.cli (python -m pbwt_tpu_torch)
  algorithms    pbwt_tpu_torch.algos.{match,likelihood}
  device ops    pbwt_tpu_torch.ops.{build,match,partition,likelihood,convert}
  kernels       pbwt_tpu_torch.ops.kernels + csrc/*.cu
"""
