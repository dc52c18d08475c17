"""Command-line tools of the port that are not serving or training entry
points: the synthetic corpus (`make_synth_corpus`), the quality grid of
a checkpoint (`nfe_quality`) and the quality of long files enhanced whole
and streamed (`stream_quality`); run each with `python -m
storm_tpu_torch.scripts.<name>`."""
