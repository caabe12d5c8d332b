"""Per-frame device operations: preprocess, fusion, ICP, raycast, kernels."""
