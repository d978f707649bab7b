"""PyTorch/CUDA port of VGGT-SLAM for one NVIDIA H100, in the module layout
of the JAX package `vggt_slam_tpu` (never imported): models/vggt, ops,
slam, main. The kernels are CUDA sources under csrc/, built by nvcc at
first use.
"""
