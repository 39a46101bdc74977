"""The rejection kernels (Murray's unbiased baseline, paper §1) for Hopper."""
