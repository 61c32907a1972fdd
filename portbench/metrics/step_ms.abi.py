"""``step_ms.abi``: ``step_ms`` of a cell whose step runs through the host
(copies and casts on the host's cores): a metric of its own, so that the
host's noise sets its own bound and not that of the card-paced cells."""

from portbench import harness

read = harness.load_module(harness.HERE / "metrics" / "step_ms.py").read
