"""Executors that run scheduled batches on the card."""
