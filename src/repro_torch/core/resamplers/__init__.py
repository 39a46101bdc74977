"""Resampler building blocks the ported kernels share."""
