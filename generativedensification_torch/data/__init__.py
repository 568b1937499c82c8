"""Synthetic probe batches."""
