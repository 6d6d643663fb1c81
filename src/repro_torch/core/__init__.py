"""Partitioned graph, exchange plan, communication and the msBFS bit plane."""
