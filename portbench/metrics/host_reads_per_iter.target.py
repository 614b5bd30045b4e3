"""``host_reads_per_iter.target``: ``host_reads_per_iter`` in a cell whose solves run
to a target, where it moves ``time_to_target_s``."""

from pathlib import Path

from portbench.manifest import load_module

read = load_module(Path(__file__).with_name("host_reads_per_iter.py")).read
