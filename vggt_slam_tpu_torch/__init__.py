"""PyTorch/CUDA port of VGGT-SLAM for one NVIDIA H100.

Mirrors the module layout of the JAX reference package `vggt_slam_tpu`
(which it never imports): models/vggt for the network, ops for attention,
geometry and the solvers, slam for the per-submap loop, main for the CLI.
The flash-attention kernels are CUDA sources under csrc/, built with nvcc
at first use.
"""
