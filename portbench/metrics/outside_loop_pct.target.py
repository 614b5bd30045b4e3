"""``outside_loop_pct.target``: ``outside_loop_pct`` in a cell whose solves run
to a target, where it moves ``time_to_target_s``."""

from pathlib import Path

from portbench.manifest import load_module

read = load_module(Path(__file__).with_name("outside_loop_pct.py")).read
