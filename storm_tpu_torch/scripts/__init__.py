"""Command-line tools of the port that are not serving or training entry
points: the synthetic corpus (`make_synth_corpus`) and the quality grid of
a checkpoint (`nfe_quality`); run each with `python -m
storm_tpu_torch.scripts.<name>`."""
