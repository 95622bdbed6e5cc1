"""Utilities: checkpoint bundles, disparity metrics."""
