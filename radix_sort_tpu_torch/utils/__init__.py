"""Harness utilities: timing/statistics, CSV schema, CLI options, profiling,
the native host baselines."""
