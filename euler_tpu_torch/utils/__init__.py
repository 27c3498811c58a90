"""Utilities of the port: metrics, run hooks, config, io and dense."""
