"""``solve_mfu.target``: ``solve_mfu`` in a cell whose solves run
to a target, where it moves ``time_to_target_s``."""

from pathlib import Path

from portbench.manifest import load_module

read = load_module(Path(__file__).with_name("solve_mfu.py")).read
