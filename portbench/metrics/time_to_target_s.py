"""``time_to_target_s``: the window's time over the solves it completed, in
a cell whose solves run until a relative error is reached: what a user
who asks for a quality waits for.  Host clock around each solve, which
ends in a synchronize."""

from pathlib import Path

from portbench.manifest import load_module

read = load_module(Path(__file__).with_name("solve_s.py")).read
