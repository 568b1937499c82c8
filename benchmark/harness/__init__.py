"""General code of the benchmark: the harness, the runners and the yardstick's
arithmetic."""
