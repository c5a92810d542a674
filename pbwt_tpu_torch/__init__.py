"""pbwt_tpu_torch: the PyTorch/CUDA port of pbwt-tpu.

A second package beside ``pbwt_tpu``, which stays the reference it is held
against output for output. The port imports torch, never jax and nothing
of ``pbwt_tpu``: its host layers (``core/``, ``io/``, the host paths of
``algos/``, the C runtime ``csrc/pbwt_native.c``) are its own copies, and
every TPU kernel on its path is a CUDA kernel written for Hopper
(``csrc/*.cu``), each with a plain-torch twin that the CPU route runs.

Layers:
  CLI           pbwt_tpu_torch.cli (python -m pbwt_tpu_torch)
  algorithms    pbwt_tpu_torch.algos.{match,likelihood}
  I/O           pbwt_tpu_torch.io.{pbwtfile,vcf,bcf,bgzf,textformats}
  core engine   pbwt_tpu_torch.core.{pbwt,engine,pack3,native,registry}
  device ops    pbwt_tpu_torch.ops.{build,match,partition,likelihood,convert}
  kernels       pbwt_tpu_torch.ops.kernels + csrc/*.cu
"""

from .version import MAJOR_VERSION, MINOR_VERSION, __version__

__all__ = ["__version__", "MAJOR_VERSION", "MINOR_VERSION"]
