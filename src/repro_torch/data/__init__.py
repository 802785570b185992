"""Seeded record streams and the paper's query set."""
