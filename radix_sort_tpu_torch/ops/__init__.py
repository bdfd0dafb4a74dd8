"""Operators of the port: sort, partition, scan, filter, aggregate, join."""
