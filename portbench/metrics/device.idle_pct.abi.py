"""``device.idle_pct.abi``: ``device.idle_pct`` of a cell whose step runs
through the host, which moves ``step_ms.abi``."""

from portbench import harness

read = harness.load_module(harness.HERE / "metrics" / "device.idle_pct.py"
                           ).read
