"""Inputs the benchmark makes from a seed and hands to the port and to the
reference alike."""
