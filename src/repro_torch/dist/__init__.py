"""Fault handling for long runs (``dist.fault``); the reference's sharding is not ported."""
