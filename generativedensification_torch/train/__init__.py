"""Training pieces of the port (so far the SSIM that evaluation reads)."""
