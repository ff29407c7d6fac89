"""Models on the port's kernels: the fused pipeline and the batch tool."""
