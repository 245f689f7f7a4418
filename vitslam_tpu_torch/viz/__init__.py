"""Eval plots (port of vitslam_tpu/viz/plots.py) and the viser viewer
(``viser_viz``, its preparation in numpy and torch; viser itself is
optional)."""
