"""3D Gaussian splatting: projection, tile binning and compositing."""
