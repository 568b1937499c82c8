"""Evaluation: metrics and the evaluation entry point."""
