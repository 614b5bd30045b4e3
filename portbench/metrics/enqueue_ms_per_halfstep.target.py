"""``enqueue_ms_per_halfstep.target``: ``enqueue_ms_per_halfstep`` in a cell whose solves run
to a target, where it moves ``time_to_target_s``."""

from pathlib import Path

from portbench.manifest import load_module

read = load_module(Path(__file__).with_name("enqueue_ms_per_halfstep.py")).read
