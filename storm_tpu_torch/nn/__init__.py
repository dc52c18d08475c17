"""NCSN++ building blocks (NCHW)."""
