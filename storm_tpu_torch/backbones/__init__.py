"""Score / denoiser backbones."""
