"""Diffusion SDEs."""
