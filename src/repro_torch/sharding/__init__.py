"""Logical-axis sharding rules (torch twin of ``repro.sharding``)."""
