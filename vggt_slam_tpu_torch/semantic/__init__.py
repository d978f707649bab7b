"""Semantic voxel map and the weight-free dense embedder."""
