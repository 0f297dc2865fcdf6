"""The benchmark of idkengine_tpu_torch: one command runs one cell once.

A cell is a renderer configuration (configs/<name>.json) under a traffic
mix (traffic/<name>.json), both named in BENCHMARK.json at the checkout's
root. The renderer's driver (renderers/<renderer>.py), the scene generator
(scenes/<generator>.py), each per-layer metric's reader
(metrics/<name>.py) and each cell's check limits (limits/<cell>.json) are
found by those names, so a new cell, configuration, traffic mix or metric
takes new files and entries only. The plain reference that decides
`correct` lives in reference/ and imports nothing of the program.
"""
