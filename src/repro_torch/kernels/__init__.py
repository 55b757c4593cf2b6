"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

  csrc/modmatmul.cu   exact (A @ B) mod p          replaces repro/kernels/modmatmul.py
  csrc/coded_grad.cu  fused worker step, N workers replaces repro/kernels/coded_grad.py
  csrc/mamba_scan.cu  Mamba-1 selective scan      replaces repro/kernels/mamba_scan.py
  csrc/mamba_scan_bwd.cu  the scan's gradient   the port's own (no TPU kernel)
  ref.py              plain PyTorch versions (CPU and CUDA alike)
  build.py            nvcc build at first use + ctypes binding
  ops.py              dispatch: CPU tensor -> plain version, CUDA -> kernel

``LAUNCHES`` counts kernel launches; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.  Reset it with ``ops.reset_launches()``.
"""

LAUNCHES: dict[str, int] = {"modmatmul": 0, "coded_grad": 0,
                            "selective_scan": 0, "selective_scan_bwd": 0}
