"""Dense batched point sets and the densification decoder's modules."""
