"""Harness: generators, drivers, trace reduction, roofline, result line."""
