"""The Metropolis kernels (paper Alg. 2, the random-access baseline) for
Hopper."""
