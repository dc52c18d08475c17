"""Spectrogram figures for TensorBoard (counterpart of
storm_tpu/utils/graphics.py; sgmse/util/graphics.py:16-101).

matplotlib is imported only when a figure is drawn: the port runs without it.
"""
from __future__ import annotations

import numpy as np

EPS_graphics = 1e-10


def _mag_db(spec) -> np.ndarray:
    """Packed-real (..., 2) or complex spectrogram -> dB magnitude relative
    to its maximum, clipped to -60..0."""
    spec = np.asarray(spec)
    if spec.shape[-1] == 2 and not np.iscomplexobj(spec):
        mag = np.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2)
    else:
        mag = np.abs(spec)
    mag = mag / (mag.max() + EPS_graphics)
    return np.clip(20 * np.log10(mag + EPS_graphics), -60.0, 0.0)


def visualize_example(mix, estimate, target, return_fig: bool = False, name: str = "",
                      sample_rate: int = 16000, hop_len: int = 128):
    """Mixture, estimate and target spectrograms side by side at -60..0 dB;
    the figure with `return_fig`, else saved as `<name>.png`."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 4), sharey=True)
    for ax, spec, title in zip(axes, [mix, estimate, target], ["Mixture", "Estimate", "Target"]):
        im = ax.imshow(_mag_db(spec), origin="lower", aspect="auto", vmin=-60, vmax=0,
                       cmap="magma")
        ax.set_title(title)
        ax.set_xlabel("Time frame")
    axes[0].set_ylabel("Frequency bin")
    fig.colorbar(im, ax=axes, shrink=0.8, label="dB")
    if return_fig:
        return fig
    fig.savefig(f"{name or 'example'}.png", dpi=120, bbox_inches="tight")
    plt.close(fig)
    return []


def visualize_one(spec, return_fig: bool = False, name: str = "one"):
    """One spectrogram at -60..0 dB; the figure with `return_fig`, else
    saved as `<name>.png`."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.imshow(_mag_db(spec), origin="lower", aspect="auto", vmin=-60, vmax=0, cmap="magma")
    ax.set_xlabel("Time frame")
    ax.set_ylabel("Frequency bin")
    if return_fig:
        return fig
    fig.savefig(f"{name}.png", dpi=120, bbox_inches="tight")
    plt.close(fig)
