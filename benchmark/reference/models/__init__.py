"""Coarse reconstruction network: ViT encoder, volume transformer, heads."""
