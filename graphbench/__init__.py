"""The port's benchmark (``python3 graphbench/run.py``); see ``run.py``."""
