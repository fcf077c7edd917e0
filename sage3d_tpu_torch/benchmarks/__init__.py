"""Measurement scripts of the port, each run as
``python -m sage3d_tpu_torch.benchmarks.<name>`` on a CUDA card:

  * ``bench``: the fwd+bwd headline at 1920x1080 with 1M Gaussians, the
    three gradient-sort modes, the ``torch`` baseline, the parity block and
    the SH degree 3 scene;
  * ``kernel_anatomy``: K2 taken apart by the anatomy probe kernel
    (``csrc/composite_anatomy.cu``), one cost block stubbed out at a time.
"""
