"""The Megopolis kernels (paper Alg. 5) for Hopper."""
