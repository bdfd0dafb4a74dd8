"""Input generators, made on the device from the run's seed."""
