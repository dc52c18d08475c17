"""Reverse-diffusion samplers."""
