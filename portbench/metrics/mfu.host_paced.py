"""``mfu`` in the cells whose rate the host's issue paces, which report
``env_steps_per_s.host_paced``: the same reading (``mfu.py``)."""

from pathlib import Path

from portbench.cells import load_reader

read = load_reader(Path(__file__).with_name("mfu.py"))
