"""The port's serving benchmark: the yardstick that later changes to the
program (``repro_torch``) are measured with.  See ``portbench/run.py``."""
