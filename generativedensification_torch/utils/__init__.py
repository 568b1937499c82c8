"""Device resolution and the Flax-to-PyTorch weight bridge."""
