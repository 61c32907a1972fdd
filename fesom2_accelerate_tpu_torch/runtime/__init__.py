"""Run-time helpers of the port: bytes-moved models (``profiling``)."""
