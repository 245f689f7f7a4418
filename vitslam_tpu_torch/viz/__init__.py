"""Eval plots (port of vitslam_tpu/viz/plots.py); the viser viewer is not
ported yet."""
