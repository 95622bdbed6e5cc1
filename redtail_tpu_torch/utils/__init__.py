"""Utilities: checkpoint bundles, disparity metrics, the typed config
bridge, logging setup."""
