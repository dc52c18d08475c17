"""Small tensor helpers."""
