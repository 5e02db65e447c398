"""Attention, fused Dense+LN and InfoNCE ops and their CUDA kernels."""
