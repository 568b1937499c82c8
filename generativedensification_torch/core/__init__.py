"""Pure-PyTorch math core: cameras, rays, spherical harmonics, rotations."""
