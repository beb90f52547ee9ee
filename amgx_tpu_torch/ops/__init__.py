"""Vector and sparse-matrix operations of the port, and its CUDA kernels
(`cuda_spmv`, built by `cuda_build`)."""
