"""Resampler surface of the port: ``core.spec`` holds the typed spec and
the built resampler."""
